from .suffix_array import build_suffix_array  # noqa: F401
from .fm_index import FMIndex, build_fm_index  # noqa: F401
