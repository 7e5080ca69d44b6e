"""Time variants of the ``blockpack_encode`` kernel on one GPU.

    python -m skyplane_tpu_torch.tools.blockpack_variants [--old SRC] NAME=FLAGS ...

Run from the repository root on a machine with a card and ``nvcc``. Each
NAME=FLAGS builds ``csrc/blockpack_encode.cu`` with those ``nvcc`` flags
(``-DBP_TILE=...``, ``-DBP_THREADS=...``; an empty FLAGS is the source as it
stands) into ``build/variants/``, one ``nvcc`` per variant, all at once.
``--old SRC`` adds a source with the earlier three-launch C entry
``(data, tags, offsets, literals, n_lit, n, bb, rows, vec, device, stream)``.
On the batch step's rows (the first 8 chunks of ``chip_smoke.make_corpus``,
B = 8 x 8 MiB, bb 512) each variant is first held against
``blockpack_encode_plain`` over 5 launches, then timed in two rounds (the
second in reverse order): CUDA events over 200 launches and the traced
device time of its kernels over 100, beside a device-to-device copy of the
same bytes. The card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from skyplane_tpu_torch.ops import kernels

OUT = kernels.BUILD_DIR.parent / "variants"
BB = 512
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGS = [_P] * 5 + [_LL, _I, _I, _I, _I, _P]


def _build(name: str, source: Path, flags: str):
    so = OUT / f"{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", f"-I{source.parent}", *flags.split(), "-o", str(so),
           str(source)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = re.findall(r"Used (\d+) registers", r.stdout + r.stderr)
    return name, so, regs


def _tile(flags: str) -> int:
    m = re.search(r"BP_TILE=(\d+)", flags)
    return int(m.group(1)) if m else kernels.BLOCKPACK_TILE


def main(argv) -> int:
    import chip_smoke as cs  # the corpus and the timing helpers, from the repository root

    old = None
    if argv[:1] == ["--old"]:
        old, argv = Path(argv[1]), argv[2:]
    variants = dict(v.split("=", 1) for v in argv)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(n, kernels.CSRC / "blockpack_encode.cu", f) for n, f in variants.items()]
    if old is not None:
        jobs.insert(0, ("old", old, ""))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: _build(*j), jobs))
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    fns = {}
    for name, so, regs in built:
        fn = ctypes.CDLL(str(so)).skyt_blockpack_encode
        fn.argtypes = OLD_ARGS if name == "old" else kernels._KERNELS["blockpack_encode"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(f"  {name} [{variants.get(name, old)}]: registers {regs}", flush=True)

    batch = torch.from_numpy(np.stack([np.frombuffer(c, np.uint8) for c in cs.make_corpus(cs.SEED)[:8]])).to(dev)
    b, n = batch.shape
    want = kernels.blockpack_encode_plain(batch, BB)

    def call(name):
        tags = torch.empty((b, n // BB), dtype=torch.uint8, device=dev)
        lit = torch.empty((b, n), dtype=torch.uint8, device=dev)
        n_lit = torch.empty((b,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "old":
            offsets = torch.empty((b, n // BB), dtype=torch.int32, device=dev)
            err = fns[name](batch.data_ptr(), tags.data_ptr(), offsets.data_ptr(), lit.data_ptr(), n_lit.data_ptr(), n,
                            BB, b, 1, dev.index, stream)
        else:
            tile = BB * max(1, _tile(variants[name]) // BB)
            scratch = torch.empty((1 + b * -(-n // tile),), dtype=torch.int64, device=dev)
            err = fns[name](batch.data_ptr(), tags.data_ptr(), lit.data_ptr(), n_lit.data_ptr(), scratch.data_ptr(),
                            scratch.numel(), n, BB, b, dev.index, stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return tags, lit, n_lit

    for name in fns:
        err = max(cs.max_abs_err(g, w) for _ in range(5) for g, w in zip(call(name), want))
        print(f"  {name}: max |kernel - plain| over 5 launches {err}", flush=True)
        if err:
            return 1
    copy_out = torch.empty_like(batch)
    events = {k: [] for k in list(fns) + ["copy"]}
    traced = {k: [] for k in fns}
    for order in (list(fns), list(reversed(list(fns)))):
        events["copy"].append(cs.time_ms(lambda: copy_out.copy_(batch), 100))
        for name in order:
            events[name].append(cs.time_ms(lambda: call(name), 200))
            traced[name].append(cs.traced_ms(lambda: call(name), "_kernel", 100))
    for name, ms in events.items():
        print(f"  {name}: {' '.join(f'{m:.4f}' for m in ms)} ms by CUDA events"
              + ("" if name == "copy" else f"; traced: {' | '.join(traced[name])}"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
