"""Native (C++) host-side image decode: JPEG/PNG bytes to RGB uint8.

See ``ipe_loader.cpp`` for the decoder and ``binding.py`` for the ctypes
interface, built at first use.  Import-safe everywhere: where g++ or
libjpeg is missing, ``available()`` is False and callers use cv2.
"""

from .binding import available, decode_rgb, has_png, image_dims, load

__all__ = ["available", "decode_rgb", "has_png", "image_dims", "load"]
