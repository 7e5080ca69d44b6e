"""Host utilities of the port (counterpart of a part of ``skyplane_tpu/utils``)."""
