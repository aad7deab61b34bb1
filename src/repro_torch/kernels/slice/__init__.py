from . import ref  # noqa: F401
