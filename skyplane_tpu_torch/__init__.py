"""PyTorch/CUDA port of the skyplane_tpu gateway data path.

The sender path (gear CDC -> candidate compaction -> segment fingerprints ->
dedup recipe -> codec) runs on an NVIDIA GPU through hand-written CUDA
kernels (``ops/kernels.py``, sources in ``csrc/``); the receiver inverse
(``restore``) runs on the host. Wire bytes are byte-identical to the JAX
package's. The fused batch step ``ops.pipeline.datapath_step`` (candidate
mask, blockpack encode, fixed-stride fingerprints) has its own three
kernels; ``entry.entry()`` is the twin of the repo's ``__graft_entry__``. Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the kernels' plain PyTorch versions instead.
"""
