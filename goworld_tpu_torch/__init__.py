"""goworld_tpu_torch — the PyTorch and CUDA port of ``goworld_tpu``.

A game server script writes its game as on the JAX package::

    import goworld_tpu_torch as gw

    @gw.register_entity("Account")
    class Account(gw.Entity): ...

    gw.run()

The facade mirrors the reference's root package ``goworld.go:34-256``:
:func:`run` reads the ini, builds the World on the card (``device="cpu"``
for tests), opens storage and kvdb and serves the World through
:class:`~goworld_tpu_torch.net.game.GameServer`.
"""

__version__ = "0.1.0"


def __getattr__(name: str):
    """Lazy facade: importing the package builds nothing and imports no
    submodule; the dispatcher and gate processes import it for config
    and wire code only.

    Submodules resolve first (so ``from goworld_tpu_torch import config``
    does not recurse through the api import); everything else proxies to
    the facade in :mod:`goworld_tpu_torch.api`."""
    import importlib

    try:
        return importlib.import_module(f"goworld_tpu_torch.{name}")
    except ModuleNotFoundError as e:
        # only swallow "no such submodule"; a submodule's own failing
        # import (e.g. a missing third-party dep) must surface as-is
        if e.name != f"goworld_tpu_torch.{name}":
            raise
    from goworld_tpu_torch import api

    try:
        return getattr(api, name)
    except AttributeError:
        raise AttributeError(
            f"module 'goworld_tpu_torch' has no attribute {name!r}"
        ) from None
