"""Where the library's Pallas kernels run: the one place that decides.

On a CUDA GPU every kernel is compiled for the card through Pallas'
Triton route. Anywhere else a kernel runs only in the Pallas
interpreter, and only after `set_interpret(True)` asked for it (the test
suite does, on its CPU mesh). Any other backend is an error that names
it: there is no silent fallback to the interpreter on the hot path.
"""

from __future__ import annotations

import jax

_INTERPRET = {"on": False}


def set_interpret(on: bool) -> None:
    """Allow Pallas kernels to run in the interpreter off the GPU."""
    _INTERPRET["on"] = bool(on)


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU (kernels compile there)."""
    return jax.default_backend() == "gpu"


def pallas_interpret() -> bool:
    """The `interpret` flag for a pallas_call built now.

    False on a GPU; True off it when interpret mode was asked for;
    otherwise raises, naming the backend."""
    if on_gpu():
        return False
    if _INTERPRET["on"]:
        return True
    raise RuntimeError(
        f"Pallas kernels compile only for a CUDA GPU, and JAX's backend is "
        f"{jax.default_backend()!r}. Use an XLA tier (impl='bsr_xla', "
        "'auto', ...) here, or call "
        "spmm_denseblock_tpu.backend.set_interpret(True) to run the kernel "
        "in the Pallas interpreter (tests only: it is slow)."
    )
