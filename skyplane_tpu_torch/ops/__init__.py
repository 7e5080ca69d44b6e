"""GPU data-path kernels and their host orchestration.

- :mod:`skyplane_tpu_torch.ops.u32`          — mod-(2^31-1) field helpers (int64 carriers)
- :mod:`skyplane_tpu_torch.ops.gear`         — Gear rolling hash + CDC boundary candidates
- :mod:`skyplane_tpu_torch.ops.cdc`          — host boundary selection and host CDC
- :mod:`skyplane_tpu_torch.ops.fingerprint`  — 8-lane polynomial segment fingerprints
- :mod:`skyplane_tpu_torch.ops.kernels`      — the CUDA kernels, their plain versions and launch counts
- :mod:`skyplane_tpu_torch.ops.fused_cdc`    — call A / call B over a padded batch
- :mod:`skyplane_tpu_torch.ops.batch_runner` — micro-batching across sender workers
- :mod:`skyplane_tpu_torch.ops.blockpack`    — blockpack container (host) and device encode/decode
- :mod:`skyplane_tpu_torch.ops.pipeline`     — datapath_step (the fused batch step), DataPathProcessor
"""
