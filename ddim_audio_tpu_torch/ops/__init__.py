"""Kernel wrappers and the fused ops built on them.

Every kernel wrapper keeps a plain launch count (``wrapper.launches``);
``launch_counts`` and ``reset_launch_counts`` read and clear them together.
"""

from .conv_flat import conv3x3_flat
from .conv_strided import conv_down_flat, conv_up_flat

KERNEL_WRAPPERS = {
    "conv3x3_flat": conv3x3_flat,
    "conv_down_flat": conv_down_flat,
    "conv_up_flat": conv_up_flat,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
