"""Multi-process byte pump: the counter schema and the sender test only.

The pump itself (``ReceiverPump``, the sender pump operator, the remote batch
runner behind the processor's ``remote`` branch) shards the gateway's wire
stack across spawn-context worker processes. It is the next slice of the port
(ROADMAP queue 1 item 5, "After it: pump.py"). Until then the daemon refuses
``SKYPLANE_TPU_PUMP_PROCS > 0`` and ``GatewayReceiver.enable_pump`` raises.

What the daemon needs already is here, with the JAX package's names and
values: :data:`PUMP_COUNTER_ZERO`, so ``/api/v1/metrics`` carries the
``skyplane_pump_*`` families at zero as a daemon with the pump off does, and
:func:`is_pump_sender`, which no operator satisfies yet.
"""

from __future__ import annotations

#: stable pump-counter schema (mirrors SENDER_WIRE_COUNTER_ZERO's role):
#: always present on /api/v1/metrics as skyplane_pump_* once a daemon runs,
#: zeros when the pump is off, so dashboards and the chaos soak can rely on
#: the shape without probing the mode.
PUMP_COUNTER_ZERO = {
    "procs": 0,  # configured worker count across pools
    "workers_alive": 0,  # gauge
    "worker_spawns": 0,
    "worker_deaths": 0,  # EOF/exit observed while not stopping
    "worker_respawns": 0,
    "conns_dispatched": 0,  # receiver fds passed to workers
    "batches_shipped": 0,  # sender windows shipped to workers
    "chunks_outstanding": 0,  # gauge: shipped, no terminal outcome yet
    "chunks_requeued_on_death": 0,
    "ctrl_messages": 0,  # messages received from workers
    "batch_rpcs_served": 0,  # codec batches workers shipped to the parent's device runner
    "batch_rpc_errors": 0,  # parent-side batch RPC failures (worker fell back to host)
}

#: the pump sender operator's class, set when the pump is ported
_SENDER_PUMP_CLS = None


def is_pump_sender(op) -> bool:
    return _SENDER_PUMP_CLS is not None and isinstance(op, _SENDER_PUMP_CLS)
