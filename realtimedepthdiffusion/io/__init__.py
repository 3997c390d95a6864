"""I/O boundary: image + annotation codecs. PNG is a numpy + zlib codec;
the only package allowed to import Pillow, for other formats (BASELINE.json:
imaging libraries confined to I/O)."""

from .image import (
    depth_to_u8,
    depth_to_u16,
    image_size,
    imread_gray,
    imread_rgb,
    imwrite,
    load_annotation,
    png_read,
    png_write,
    save_annotation,
)

__all__ = [
    "depth_to_u8",
    "depth_to_u16",
    "image_size",
    "imread_gray",
    "imread_rgb",
    "imwrite",
    "load_annotation",
    "png_read",
    "png_write",
    "save_annotation",
]
