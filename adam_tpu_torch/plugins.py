"""User plugins over read datasets (the port's counterpart of
``adam_tpu/plugins.py``, the reference's ``plugins/`` package).

* :class:`AdamPlugin`: an optional column ``projection`` (Parquet column
  names, pushed down into the read of a ``.adam``/``.parquet`` input), an
  optional row ``predicate`` (the loaded :class:`ReadBatch` -> a
  ``bool[N]`` mask, numpy or a CPU tensor) and a ``run`` over the loaded,
  filtered dataset.
* :class:`AccessControl` / :class:`EmptyAccessControl`: a site policy's
  predicate, ANDed with the plugin's own (PluginExecutor.scala:98-107).
* :func:`load_plugin`: the reflective loader of a ``"pkg.module.Class"``.

The loading and masking here are host code, as in the JAX package.
"""

from __future__ import annotations

import importlib
from typing import Optional, Sequence

import numpy as np

from adam_tpu_torch.api.datasets import AlignmentDataset


class AdamPlugin:
    """Base class for user plugins over read datasets."""

    #: Optional list of Parquet column names to project (None = all).
    projection: Optional[Sequence[str]] = None

    def predicate(self, batch) -> Optional[np.ndarray]:
        """Optional row mask ``bool[N]`` over a ReadBatch (None = keep all)."""
        return None

    def run(self, ds: AlignmentDataset, args: Sequence[str]):
        """Body of the plugin; returns any sequence of printable results."""
        raise NotImplementedError


class AccessControl:
    """Site access policy: a row mask composed with every plugin's own."""

    def predicate(self, batch) -> Optional[np.ndarray]:
        return None


class EmptyAccessControl(AccessControl):
    """The default allow-everything policy (plugins/EmptyAccessControl.scala)."""


def load_plugin(qualname: str, base=AdamPlugin):
    """Instantiate ``"pkg.module.ClassName"`` after checking that it is a
    subclass of ``base``: ``ValueError`` for a name without a dot,
    ``TypeError`` for anything that is not a ``base``."""
    mod_name, _, cls_name = qualname.rpartition(".")
    if not mod_name:
        raise ValueError(f"plugin {qualname!r} must be a dotted path")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    if not (isinstance(cls, type) and issubclass(cls, base)):
        raise TypeError(f"{qualname} is not a {base.__name__}")
    return cls()


def _as_mask(m) -> np.ndarray:
    if hasattr(m, "detach"):  # a torch tensor: only a host one is a mask here
        if m.device.type != "cpu":
            raise ValueError(f"a predicate's mask must be numpy or a CPU tensor, "
                             f"not on {m.device}")
        m = m.detach().numpy()
    return np.asarray(m, bool)


def compose_predicates(batch, *sources) -> Optional[np.ndarray]:
    """AND the non-None predicates of the plugin and the access control
    -> bool[N], or None when none filters."""
    mask = None
    for src in sources:
        m = src.predicate(batch)
        if m is None:
            continue
        m = _as_mask(m)
        mask = m if mask is None else (mask & m)
    return mask


def execute_plugin(
    plugin: AdamPlugin,
    input_path: str,
    plugin_args: Sequence[str] = (),
    access_control: Optional[AccessControl] = None,
    device: str = "cuda",
):
    """Load (the projection pushed down into a Parquet read), filter, run:
    the PluginExecutor lifecycle (PluginExecutor.scala:88-119).  The
    ``device`` is checked as every entry point of the port checks it
    (``cuda`` without a card raises), though the lifecycle itself is host
    code."""
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io import context

    resolve_device(device)
    kw = {}
    if plugin.projection is not None and str(input_path).endswith((".adam", ".parquet")):
        kw["projection"] = list(plugin.projection)
    ds = context.load_alignments(str(input_path), **kw)
    ac = access_control or EmptyAccessControl()
    mask = compose_predicates(ds.batch, ac, plugin)
    if mask is not None:
        ds = ds.take_rows(np.flatnonzero(mask & np.asarray(ds.batch.valid)))
    return plugin.run(ds, list(plugin_args))
