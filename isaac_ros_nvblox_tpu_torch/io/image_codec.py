"""Image files of the dataset loaders and writers: PNG with zlib alone,
JPEG through the codec the host has.

PNG decode covers what the datasets hold: 8-bit gray, RGB and RGBA and
16-bit big-endian gray, non-interlaced. The scanlines are inflated with
zlib and unfiltered by the host library (`native.png_unfilter`, built with
g++ on first use; a failed build raises). The encoder writes 8-bit gray,
8-bit RGB and 16-bit gray: per row the adaptive filter of least absolute
sum, deflate level 6 with the filtered strategy, IDAT chunks of
max(65536, 4 * width) bytes; for 8-bit gray that is byte for byte what
Pillow writes.

JPEG goes through the first codec that imports: Pillow, imageio, then
torchvision's `decode_jpeg` / `encode_jpeg`. Without one, reading or
writing a JPEG raises and names the file; nothing returns an empty image
for a file that exists.
"""

from __future__ import annotations

import importlib
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from isaac_ros_nvblox_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (gray, RGB, RGBA).
_CHANNELS = {0: 1, 2: 3, 6: 4}
JPEG_CODECS = ("PIL", "imageio", "torchvision")


# ------------------------------------------------------------------- PNG
def decode_png(data: bytes) -> np.ndarray:
    """A PNG's pixels: u8[H, W] (gray), u8[H, W, 3|4] (RGB, RGBA) or
    u16[H, W] (16-bit gray). Raises ValueError on anything else."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or interlace != 0 or (
            depth not in (8, 16) or (depth == 16 and ctype != 0)):
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    rows = native.png_unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    if ctype == 0:
        return rows.reshape(height, width)
    return rows.reshape(height, width, _CHANNELS[ctype])


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def _filtered_rows(rows: np.ndarray, bpp: int) -> bytes:
    """The filtered scanlines of u8[H, row_bytes]: each row gets the
    filter (none, sub, up, average, Paeth) whose bytes, read as signed,
    have the least absolute sum; ties go to the first of none, up, sub,
    average, Paeth."""
    cur = rows.astype(np.int32)
    H, n = cur.shape
    up = np.vstack([np.zeros((1, n), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((H, bpp), np.int32), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((H, bpp), np.int32), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    cands = np.stack([cur, cur - left, cur - up, cur - (left + up) // 2,
                      cur - paeth]) % 256
    cost = np.minimum(cands, 256 - cands).sum(axis=2)
    order = np.asarray([0, 2, 1, 3, 4])
    best = order[np.argmin(cost[order], axis=0)]
    out = cands[best, np.arange(H)].astype(np.uint8)
    return np.hstack([best[:, None].astype(np.uint8), out]).tobytes()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """A PNG of u8[H, W] (gray), u8[H, W, 3] (RGB) or u16[H, W] (16-bit
    gray)."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype, rows = 8, 0, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, rows = 8, 2, img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot encode {img.dtype}{list(img.shape)} as PNG")
    H, W = img.shape[:2]
    bpp = _CHANNELS[ctype] * depth // 8
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(_filtered_rows(rows.reshape(H, W * bpp), bpp)) \
        + z.flush()
    step = max(65536, 4 * W)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                          0, 0, 0))
            + b"".join(_chunk(b"IDAT", data[i:i + step])
                       for i in range(0, len(data), step))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))


# ------------------------------------------------------------------- JPEG
def jpeg_codec() -> Optional[str]:
    """The first JPEG codec that imports on this host (of JPEG_CODECS), or
    None."""
    for name in JPEG_CODECS:
        try:
            importlib.import_module(name)
        except ImportError:
            continue
        return name
    return None


def _no_codec(path) -> RuntimeError:
    return RuntimeError(f"{path}: no JPEG codec on this host (tried "
                        f"{', '.join(JPEG_CODECS)})")


def read_jpeg(path) -> np.ndarray:
    """u8[H, W, 3] of a JPEG file."""
    path = Path(path)
    codec = jpeg_codec()
    if codec == "PIL":
        from PIL import Image
        with Image.open(path) as im:
            return np.array(im.convert("RGB"))
    if codec == "imageio":
        import imageio.v2 as imageio
        return np.array(imageio.imread(path))
    if codec == "torchvision":
        import torch
        from torchvision.io import decode_jpeg
        data = torch.frombuffer(bytearray(path.read_bytes()),
                                dtype=torch.uint8)
        return decode_jpeg(data).permute(1, 2, 0).numpy()
    raise _no_codec(path)


def write_jpeg(path, img: np.ndarray) -> None:
    """Write u8[H, W, 3] as a JPEG at the codec's default quality."""
    path = Path(path)
    img = np.ascontiguousarray(img, np.uint8)
    codec = jpeg_codec()
    if codec == "PIL":
        from PIL import Image
        Image.fromarray(img).save(path, format="JPEG")
    elif codec == "imageio":
        import imageio.v2 as imageio
        imageio.imwrite(path, img)
    elif codec == "torchvision":
        import torch
        from torchvision.io import encode_jpeg
        data = encode_jpeg(torch.from_numpy(img).permute(2, 0, 1))
        path.write_bytes(data.numpy().tobytes())
    else:
        raise _no_codec(path)


def read_image(path) -> np.ndarray:
    """A PNG or JPEG file's pixels, by suffix."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return read_png(path)
    if path.suffix.lower() in (".jpg", ".jpeg"):
        return read_jpeg(path)
    raise ValueError(f"{path}: not a PNG or JPEG file")
