"""Spot/preemptible-instance preemption watcher.

Cloud providers announce a spot reclaim 30–120 s before the kill: AWS posts
``spot/instance-action`` on the instance metadata service, GCP flips the
``instance/preempted`` metadata flag. The watcher polls that signal (and, in
tests, the ``gateway.preempt_notice`` fault point) on its own thread and
fires ``on_notice`` exactly once — the daemon's ``begin_drain`` — so an
announced preemption becomes a graceful drain (stop admission, flush
in-flight frames, fsync the dedup journal + segment spill) instead of a
crash the tracker discovers a heartbeat-deadline later
(docs/provisioning.md "Repair & drain").

The watcher starts only when explicitly requested (``preempt_watch=True`` on
the daemon, or ``SKYPLANE_TPU_PREEMPT_WATCH`` naming a provider) — a
localhost harness daemon must never burn cycles probing a metadata service
that is not there. Metadata probes use sub-second timeouts: the watcher's
whole point is a bounded reaction window. They go through the port's
standard-library control client (``gateway/control_auth.py``), so a GPU
gateway host need not have ``requests``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.gateway.control_auth import ControlRequestError, control_session
from skyplane_tpu_torch.utils.envcfg import env_float
from skyplane_tpu_torch.utils.logger import logger

#: AWS IMDS spot interruption notice: 200 here means a reclaim is scheduled
AWS_SPOT_ACTION_URL = "http://169.254.169.254/latest/meta-data/spot/instance-action"
#: GCP metadata preemption flag: body "TRUE" means the VM is being preempted
GCP_PREEMPTED_URL = "http://metadata.google.internal/computeMetadata/v1/instance/preempted"


def aws_metadata_probe() -> Optional[str]:
    """Non-empty description when AWS has scheduled a spot interruption."""
    try:
        r = control_session().get(AWS_SPOT_ACTION_URL, timeout=0.5)
    except ControlRequestError:
        return None  # metadata service unreachable: not a notice
    if r.status_code == 200:
        return f"aws spot instance-action: {r.text[:200]}"
    return None


def gcp_metadata_probe() -> Optional[str]:
    """Non-empty description when GCP has flagged this VM preempted."""
    try:
        r = control_session().get(GCP_PREEMPTED_URL, headers={"Metadata-Flavor": "Google"}, timeout=0.5)
    except ControlRequestError:
        return None
    if r.status_code == 200 and r.text.strip().upper() == "TRUE":
        return "gcp preemption flag TRUE"
    return None


METADATA_PROBES = {"aws": aws_metadata_probe, "gcp": gcp_metadata_probe}


def probe_for(provider: str) -> Optional[Callable[[], Optional[str]]]:
    """The metadata probe for a provider name ('' / unknown -> None: the
    watcher then only serves the injected fault point)."""
    return METADATA_PROBES.get((provider or "").strip().lower())


class PreemptionWatcher(threading.Thread):
    """Polls for a preemption notice; calls ``on_notice(reason)`` once.

    Daemon thread AND joined by the owner's stop path (``stop()``), per the
    ``unjoined-thread-in-gateway`` lint contract: the watcher must never
    outlive daemon shutdown.
    """

    def __init__(
        self,
        on_notice: Callable[[str], None],
        *,
        probe: Optional[Callable[[], Optional[str]]] = None,
        poll_s: Optional[float] = None,
        name: str = "preempt-watcher",
    ):
        super().__init__(name=name, daemon=True)
        self.on_notice = on_notice
        self.probe = probe
        self.poll_s = poll_s if poll_s is not None else env_float("SKYPLANE_TPU_PREEMPT_POLL_S", 1.0)
        self._halt = threading.Event()
        self.fired_reason: Optional[str] = None

    def run(self) -> None:
        while not self._halt.wait(self.poll_s):
            reason = self._check_once()
            if reason:
                self.fired_reason = reason
                logger.fs.warning(f"[{self.name}] preemption notice: {reason}")
                try:
                    self.on_notice(reason)
                except Exception as e:  # noqa: BLE001 — a failed drain kick must not kill the watcher silently
                    logger.fs.error(f"[{self.name}] on_notice failed: {e}")
                return  # one notice is terminal: the gateway is draining

    def _check_once(self) -> Optional[str]:
        inj = get_injector()
        if inj.enabled and inj.fire("gateway.preempt_notice"):
            # docs/fault-injection.md: synthetic preemption — exercises the
            # exact drain path a real metadata notice takes
            return "injected preemption notice (gateway.preempt_notice)"
        if self.probe is not None:
            try:
                return self.probe()
            except Exception as e:  # noqa: BLE001 — a broken probe must not kill the watcher
                logger.fs.debug(f"[{self.name}] metadata probe failed: {e}")
        return None

    def stop(self, timeout: float = 2.0) -> None:
        self._halt.set()
        self.join(timeout=timeout)
