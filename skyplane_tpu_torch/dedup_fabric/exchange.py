"""Fingerprint-summary exchange: the gossip round that compounds warmth.

One round pulls each gateway's recently-proved fingerprint summary
(``GET /api/v1/fabric/summary``) and re-posts it to every *other* gateway
(``POST /api/v1/fabric/summary``), whose fabric absorbs it into live sender
dedup indexes and pump-worker partitions. The PR-14 service controller
piggybacks a round on its heartbeat cadence (`ServiceController.tick`);
soaks and tests call :func:`run_summary_exchange` directly.

Stale gossip is safe by construction: an absorbed fingerprint the owner has
since evicted degrades to one NACK -> literal resend (the PR-6 contract);
it can never corrupt data, so the exchange needs no acks, ordering, or
retries — a failed leg is skipped and the next round catches up.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from skyplane_tpu_torch.utils.logger import logger


def run_summary_exchange(gateways: Iterable[Tuple[str, object]], timeout: float = 10.0) -> Dict[str, int]:
    """One all-pairs gossip round over ``(control_url, session)`` pairs.

    ``gateways`` yields ``(base_control_url, session)``, the session (a
    ``control_auth.ControlSession``) already authenticated for that gateway
    (the service's ``BoundGateway.control_session()``). Returns counters for the caller's
    telemetry: summaries pulled, legs posted, legs failed, fps moved.
    """
    pairs: List[Tuple[str, object]] = [(_api_base(url), sess) for url, sess in gateways]
    stats = {"pulled": 0, "posted": 0, "failed": 0, "fps": 0}
    summaries: List[Optional[dict]] = []
    for base, sess in pairs:
        try:
            resp = sess.get(f"{base}/fabric/summary", timeout=timeout)
            resp.raise_for_status()
            doc = resp.json()
            summaries.append(doc if isinstance(doc, dict) else None)
            stats["pulled"] += 1
        except Exception as e:  # noqa: BLE001 — a missing leg is caught up next round
            summaries.append(None)
            stats["failed"] += 1
            logger.fs.debug(f"[fabric-exchange] summary pull from {base} failed: {e}")
    for i, summary in enumerate(summaries):
        if not summary or not summary.get("fps"):
            continue
        stats["fps"] += len(summary["fps"])
        for j, (base, sess) in enumerate(pairs):
            if j == i:
                continue
            try:
                resp = sess.post(f"{base}/fabric/summary", json=summary, timeout=timeout)
                resp.raise_for_status()
                stats["posted"] += 1
            except Exception as e:  # noqa: BLE001
                stats["failed"] += 1
                logger.fs.debug(f"[fabric-exchange] summary post to {base} failed: {e}")
    return stats


def _api_base(url: str) -> str:
    url = url.rstrip("/")
    return url if url.endswith("/api/v1") else url + "/api/v1"
