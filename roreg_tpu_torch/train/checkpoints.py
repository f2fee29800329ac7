"""Checkpoints of the trained heads, in the layout the pipeline reads.

Counterpart of ``roreg_tpu/train/checkpoints.py``. The JAX package saves
orbax trees; the card has no orbax, so a checkpoint here is a directory in
the layout of ``checkpoints/quality_full/``: ``<comp>.npz`` (the network's
variables under their flat JAX paths, float32) and ``config_tag.json``
(the group size), which ``weights.load_components`` and
``weights.load_checkpoint_dir`` read. A trainer's checkpoint adds
``train_state.npz``: the step count and Adam's two moments of every
parameter under the same paths, so that a resumed run continues step for
step. The backbone's training writes its variables alone to
``<dir>/backbone_variables`` (the JAX package's raw-variables layout).
The trainer writes ``<model_dir>/<COMP>/model`` (every
``save_interval`` steps) and ``<model_dir>/<COMP>/model_best`` (at the
validation gate); ``model_dir`` is the caller's, never the tracked tree.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from roreg_tpu_torch.weights import (
    _leaves,
    export_variables,
    flatten_variables,
    load_components,
    load_variables,
    unflatten_variables,
)

__all__ = ["save_variables", "save_train_state", "load_train_state", "load_pipeline_variables"]

COMPONENTS = ("backbone", "gf", "rd", "rm", "et")
_TRAIN_STATE = "train_state.npz"


def save_variables(path: str, comp: str, variables: dict, group_size: int) -> None:
    """Write one network's variables (nested numpy, JAX layout) as
    ``<path>/<comp>.npz`` with the set's ``config_tag.json``."""
    os.makedirs(path, exist_ok=True)
    flat = {k: np.asarray(v, np.float32) for k, v in flatten_variables(variables).items()}
    np.savez(os.path.join(path, f"{comp}.npz"), **flat)
    with open(os.path.join(path, "config_tag.json"), "w") as f:
        json.dump({"group_size": group_size, "components": [comp]}, f)


def _param_leaves(net: torch.nn.Module):
    """(tensor, flat JAX path, transposed) of each trained parameter."""
    for t, path, transposed in _leaves(net):
        if path[0] == "params":
            yield t, "/".join(path), transposed


def save_train_state(path: str, comp: str, state) -> None:
    """A trainer's state (``trainer.TrainState``): the network's variables
    and ``train_state.npz`` (``step``, ``m/<path>`` and ``v/<path>``)."""
    save_variables(path, comp, export_variables(state.net), state.group_size)
    out = {"step": np.asarray(state.step, np.int64)}
    for t, key, transposed in _param_leaves(state.net):
        st = state.optimizer.state.get(t, {})
        for name, slot in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            a = st[slot].detach().cpu().numpy() if slot in st else np.zeros(tuple(t.shape), np.float32)
            out[f"{name}/{key}"] = np.array(a.T if transposed else a, order="C")
    np.savez(os.path.join(path, _TRAIN_STATE), **out)


def load_train_state(path: str, comp: str, state) -> bool:
    """Restore what :func:`save_train_state` wrote into ``state``: the
    network's variables, Adam's moments and the step. False when ``path``
    holds no such checkpoint."""
    var_fn, st_fn = os.path.join(path, f"{comp}.npz"), os.path.join(path, _TRAIN_STATE)
    if not (os.path.exists(var_fn) and os.path.exists(st_fn)):
        return False
    with np.load(var_fn) as z:
        load_variables(state.net, unflatten_variables({k: z[k] for k in z.files}))
    with np.load(st_fn) as z:
        step = int(z["step"])
        for t, key, transposed in _param_leaves(state.net):
            slots = {}
            for name, slot in (("m", "exp_avg"), ("v", "exp_avg_sq")):
                a = z[f"{name}/{key}"]
                slots[slot] = torch.from_numpy(np.array(a.T if transposed else a, order="C")).to(t.device)
            state.optimizer.state[t] = {"step": torch.tensor(float(step)), **slots}
    state.step = step
    return True


def load_pipeline_variables(checkpoint_dir: str, variables: dict, cfg) -> list[str]:
    """Replace in ``variables`` (the pipeline's, nested numpy) each network
    whose checkpoint lies in ``checkpoint_dir``, in any of the layouts:
    ``<dir>/<comp>.npz`` (a converted set), ``<dir>/<comp>_variables``
    (raw variables, as the backbone's training writes them) or
    ``<dir>/<COMP>/model_best`` (a trainer's best checkpoint). Returns the
    loaded names."""
    loaded = []
    for comp in COMPONENTS:
        raw = os.path.join(checkpoint_dir, f"{comp}_variables")
        best = os.path.join(checkpoint_dir, comp.upper(), "model_best")
        for path in (checkpoint_dir, raw, best):
            if os.path.exists(os.path.join(path, f"{comp}.npz")) and comp in variables:
                loaded += load_components(path, cfg, variables, (comp,))
                break
    return loaded
