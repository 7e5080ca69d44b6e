"""Content-hash cache for repeated lint runs.

``run_paths`` over the whole package parses 150+ files and runs every checker
on each — a few seconds that the port's gate, ``chip_smoke.py`` and ad-hoc
``skyplane-tpu-torch lint`` invocations each pay again on a tree that has not
changed. This module
caches at two granularities, both keyed so a stale hit is impossible:

  * **run entries** — the complete findings list for one (file set, digests,
    flags) tuple. An unchanged tree is a full hit: no parsing at all.
  * **per-file entries** — one module's per-module checker findings keyed by
    that file's content digest. After a single-file edit the other 150+ files
    skip their checker pass (they are still PARSED, because the whole-program
    passes legitimately need every AST — a one-level summary of a callee in
    the edited file can change findings attributed to an unchanged caller,
    which is also why project-pass findings are only cached at run scope).

Every key additionally bakes in a fingerprint of the ``analysis/`` package
sources, so editing any checker invalidates everything at once; bumping
``_VERSION`` does the same for format changes. The cache file lives at the
repo root (``.sklint-cache-torch.json``, git-ignored; ``SKYPLANE_TPU_SKLINT_CACHE``
overrides it) and is written atomically — a concurrent lint at worst wastes
one write, never reads a torn file. It is not the JAX package's
``.sklint-cache.json``: the two packages' fingerprints differ, so one shared
file would be wiped by each lint in turn, and both gates run at once.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from skyplane_tpu_torch.analysis.core import Finding

_VERSION = 1
#: run entries kept per cache file (gate + chip_smoke + a couple of ad-hoc
#: invocations with different flags); oldest evicted first
_MAX_RUNS = 8

_ENV_PATH = "SKYPLANE_TPU_SKLINT_CACHE"


def content_digest(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8", errors="replace")).hexdigest()


def _analysis_fingerprint() -> str:
    """Digest of the analysis package itself: any checker/CFG/registry edit
    must invalidate every cached finding."""
    h = hashlib.sha256()
    pkg = Path(__file__).resolve().parent
    for p in sorted(pkg.glob("*.py")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def default_cache_path() -> Path:
    env = os.environ.get(_ENV_PATH)
    if env:
        return Path(env)
    # repo root: skyplane_tpu_torch/analysis/cache.py -> two parents up
    return Path(__file__).resolve().parents[2] / ".sklint-cache-torch.json"


class AnalysisCache:
    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.fingerprint = _analysis_fingerprint()
        self.hits = 0  # per-file entries reused this run
        self.misses = 0  # per-file entries recomputed this run
        self.full_hit = False  # the whole run came from one run entry
        self._dirty = False
        self._data = self._load()

    # ---- persistence ----

    def _load(self) -> dict:
        empty = {"version": _VERSION, "fingerprint": self.fingerprint, "files": {}, "runs": {}}
        try:
            data = json.loads(self.path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return empty
        if (
            not isinstance(data, dict)
            or data.get("version") != _VERSION
            or data.get("fingerprint") != self.fingerprint
        ):
            return empty  # analysis code or format changed: start over
        data.setdefault("files", {})
        data.setdefault("runs", {})
        return data

    def save(self) -> None:
        if not self._dirty:
            return
        runs = self._data["runs"]
        while len(runs) > _MAX_RUNS:
            runs.pop(next(iter(runs)))  # dicts preserve insertion order
        payload = json.dumps(self._data)
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent), prefix=self.path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                os.replace(tmp, self.path)
            except BaseException:
                os.unlink(tmp)
                raise
        except OSError:
            pass  # a read-only checkout just runs uncached every time

    # ---- run-scoped entries (full findings list, zero parsing on hit) ----

    def run_key(self, digests: Sequence[Tuple[str, str]], check_suppressions: bool) -> str:
        h = hashlib.sha256()
        h.update(f"v{_VERSION}:{self.fingerprint}:{int(check_suppressions)}".encode())
        for display, digest in digests:  # order = file order = part of the key
            h.update(f"{display}\0{digest}\0".encode())
        return h.hexdigest()

    def get_run(self, key: str) -> Optional[List[Finding]]:
        entry = self._data["runs"].get(key)
        if entry is None:
            return None
        self.full_hit = True
        return [Finding(**d) for d in entry["findings"]]

    def put_run(self, key: str, findings: Sequence[Finding]) -> None:
        self._data["runs"].pop(key, None)  # re-insert at the tail (LRU-ish)
        self._data["runs"][key] = {"findings": [f.as_dict() for f in findings]}
        self._dirty = True

    # ---- per-file entries (per-module checker findings only) ----

    def get_module(self, display: str, digest: str) -> Optional[List[Finding]]:
        entry = self._data["files"].get(display)
        if entry is None or entry.get("digest") != digest:
            self.misses += 1
            return None
        self.hits += 1
        return [Finding(**d) for d in entry["findings"]]

    def put_module(self, display: str, digest: str, findings: Sequence[Finding]) -> None:
        self._data["files"][display] = {"digest": digest, "findings": [f.as_dict() for f in findings]}
        self._dirty = True

    def info(self) -> Dict[str, object]:
        return {
            "path": str(self.path),
            "full_hit": self.full_hit,
            "files_reused": self.hits,
            "files_recomputed": self.misses,
        }
