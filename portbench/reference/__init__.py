"""The plain reference: ``model.py`` around the layer of a configuration's
family, ``<family>.py``, found by the name the configuration gives under
``reference``. Whatever is the family's own lives in its module, so that a
new family is a new file:

- ``layer(x, p, c, fp8, want_cache)``: one layer, plain, and its cache;
- ``leaves(c, std, res_std)``: the weight layout of its ``blocks.*`` leaves;
- ``matrix_params(c)``: the parameters a token is multiplied by in one layer;
- ``mixer_flops(c, b, s)``: one layer's forward FLOPs over [b, s] beside
  those products (attention's two products, the SSD's chunked products);
- ``program_cache(cache, s)``: the part of the program's decode buffers
  that a prompt of ``s`` filled, under the names ``layer`` gives its cache;
- ``TINY``: the sizes at which the CPU tests run the family.

``c`` is the configuration's ``port`` sizes with its ``reference`` name
(``sizes``)."""
from __future__ import annotations

import importlib


def sizes(config: dict) -> dict:
    """The sizes the reference and the yardstick read: the configuration's
    ``port`` block and the name of its family."""
    return dict(config["port"], reference=config["reference"])


def family(c: dict):
    """The module of ``c``'s family; an unknown family raises."""
    name = f"{__name__}.{c['reference']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference family {c['reference']!r}: "
                         f"reference/{c['reference']}.py is missing") from None
