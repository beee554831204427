"""Warning hierarchy: a copy of `spateo_tpu.warnings` (reference
spateo/warnings.py:1-14)."""


class PreprocessingWarning(UserWarning):
    pass


class IOWarning(UserWarning):
    pass


class PlottingWarning(UserWarning):
    pass


class SegmentationWarning(UserWarning):
    pass
