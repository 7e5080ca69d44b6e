"""Multi-device scaling of the data path over a (data, seq) grid of devices.

The counterpart of ``skyplane_tpu/parallel``: chunk batches shard over the
``data`` axis, and long chunks shard within the byte dimension over the
``seq`` axis with a 32-byte halo for the rolling-hash window. One process
drives every device (``datapath_spmd.py``).
"""

from skyplane_tpu_torch.parallel.datapath_spmd import Mesh, default_mesh, make_spmd_datapath

__all__ = ["Mesh", "make_spmd_datapath", "default_mesh"]
