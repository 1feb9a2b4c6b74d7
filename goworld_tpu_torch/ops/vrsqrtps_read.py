"""Read ``vrsqrtps``'s estimate table off the CPU this runs on (x86-64
with AVX, Linux), the table :func:`goworld_tpu_torch.ops.xla_order.rsqrt_x86`
looks up::

    python -m goworld_tpu_torch.ops.vrsqrtps_read   # checks, then writes

The instruction's result depends on the input's exponent (halved) and on
the top 10 bits of its mantissa only: the script runs it on every
mantissa at four exponents to check that, then keeps the 2 x 1024
results at exponent fields 128 and 127 in ``vrsqrtps_table.npy``. The
reference's JAX runs on such a CPU; another model's instruction (AMD's
differs) gives another table.
"""

from __future__ import annotations

import ctypes
import mmap
from pathlib import Path

import numpy as np

# rdi = src, rsi = dst, rdx = count (a multiple of 8):
#   xor eax, eax
#   loop: vmovups ymm0, [rdi + rax*4]; vrsqrtps ymm0, ymm0
#         vmovups [rsi + rax*4], ymm0; add rax, 8; cmp rax, rdx; jb loop
#   vzeroupper; ret
_CODE = bytes([0x31, 0xC0, 0xC5, 0xFC, 0x10, 0x04, 0x87, 0xC5, 0xFC, 0x52,
               0xC0, 0xC5, 0xFC, 0x11, 0x04, 0x86, 0x48, 0x83, 0xC0, 0x08,
               0x48, 0x39, 0xD0, 0x72, 0xE9, 0xC5, 0xF8, 0x77, 0xC3])


def vrsqrtps(x: np.ndarray) -> np.ndarray:
    """The instruction's result on each float32 of ``x``."""
    page = mmap.mmap(-1, mmap.PAGESIZE, prot=mmap.PROT_READ
                     | mmap.PROT_WRITE | mmap.PROT_EXEC)
    try:
        page.write(_CODE)
        fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_size_t)(
            ctypes.addressof(ctypes.c_char.from_buffer(page)))
        x = np.ascontiguousarray(x, np.float32).reshape(-1)
        src = np.concatenate([x, np.ones(-x.size % 8, np.float32)])
        dst = np.zeros_like(src)
        fn(src.ctypes.data, dst.ctypes.data, src.size)
        del fn
        return dst[:x.size]
    finally:
        page.close()


def read_table() -> np.ndarray:
    """int32[2, 1024]: the result bits at exponent fields 128 and 127
    for each top-10-bit mantissa, after checking on every mantissa at
    four exponents that no other bit moves the result."""
    m = np.arange(1 << 23, dtype=np.uint32)
    for e in (1, 127, 128, 200):
        y = vrsqrtps(((np.uint32(e) << 23) | m).view(np.float32))
        if not np.array_equal(y.reshape(1024, -1),
                              np.repeat(y[::8192, None], 8192, 1)):
            raise RuntimeError(f"vrsqrtps depends on more than the top 10 "
                               f"mantissa bits at exponent {e}")
    top = (np.arange(1024, dtype=np.uint32) << 13)
    return np.stack([vrsqrtps(((np.uint32(e) << 23) | top).view(np.float32))
                     .view(np.int32) for e in (128, 127)])


if __name__ == "__main__":
    out = Path(__file__).with_name("vrsqrtps_table.npy")
    np.save(out, read_table())
    print(f"wrote {out}")
