"""The exceptions the data path raises (counterpart of skyplane_tpu/exceptions.py)."""

class SkyplaneTpuException(Exception):
    """Base class for all data-path errors (a malformed wire header raises it)."""


class ChecksumMismatchException(SkyplaneTpuException):
    """Restored bytes do not match the length or fingerprint the header declared."""


class DedupIntegrityException(SkyplaneTpuException):
    """A dedup recipe referenced a fingerprint the receiver cannot resolve."""


class CodecException(SkyplaneTpuException):
    """Compression / decompression failure on the data path."""


class MissingDependencyException(SkyplaneTpuException):
    """A tool or library the data path needs is not installed (g++ for the native library)."""
