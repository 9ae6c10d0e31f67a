from .lib import get_lib, native_available  # noqa: F401
