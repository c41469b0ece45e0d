"""Native (C++) host-side image loading: JPEG/PNG bytes to RGB uint8, and
the training loader's fused decode + affine crop.

See ``ipe_loader.cpp`` for the code and ``binding.py`` for the ctypes
interface, built at first use.  Import-safe everywhere: where g++ or
libjpeg is missing, ``available()`` is False.
"""

from .binding import (available, decode_rgb, decode_warp, decode_warp_batch,
                      has_png, image_dims, load)

__all__ = ["available", "decode_rgb", "decode_warp", "decode_warp_batch",
           "has_png", "image_dims", "load"]
