"""Exception hierarchy: a copy of `spateo_tpu.errors`, so that the port raises
the same classes without importing the JAX package."""


class SpateoError(Exception):
    """Base class for all framework errors."""


class ConfigurationError(SpateoError):
    """Raised for invalid configuration or AnnData-schema violations."""


class IOError(SpateoError):
    """Raised for errors while reading platform files."""


class PreprocessingError(SpateoError):
    """Raised for errors during preprocessing."""


class SegmentationError(SpateoError):
    """Raised for errors during cell segmentation."""


class AlignmentError(SpateoError):
    """Raised for errors during slice alignment."""


class DigitizationError(SpateoError):
    """Raised for errors during domain digitization."""


class MeshError(SpateoError):
    """Raised for invalid device-mesh / sharding configuration (TPU-native addition)."""


class PlottingError(SpateoError):
    """Raised for errors during plotting."""
