from . import alphabet  # noqa: F401
