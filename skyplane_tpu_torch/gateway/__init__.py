"""Gateway data plane of the port: operators over chunk queues, the wire
sender, the receiver and the chunk store (counterpart of skyplane_tpu/gateway/).

Reference parity: skyplane/gateway/ (SURVEY §2.2). Architectural differences
from the reference:

  * The compress/encrypt stage is the GPU data path (ops/), not CPU LZ4/NaCl
    only — codecs are carried per-chunk in the wire header, with the same
    ids as the JAX package's, so the two packages' gateways interoperate.
  * Workers are threads (the byte pump holds the GIL only in socket/file
    syscalls, and torch releases it while it waits on the card);
    ``n_processes`` semantics from the reference map to ``n_workers``.
  * ``gateway_daemon.GatewayDaemon`` builds these operators from a gateway
    program on an explicit ``device`` and serves the control API
    (``gateway_daemon_api.py``); ``python -m
    skyplane_tpu_torch.gateway.gateway_daemon`` starts one, pinned by
    ``SKYPLANE_GATEWAY_DEVICE``.
"""
