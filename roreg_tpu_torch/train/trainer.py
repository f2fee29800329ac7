"""Step-based training of the four heads (GF, RD, RM, ET).

Counterpart of ``roreg_tpu/train/trainer.py``: Adam with an exponential
learning-rate decay, periodic validation with a best-checkpoint gate by a
per-component metric, and a step-accurate resume. A step is forward, loss,
backward and one Adam update, with the heads' batch norms in training mode
(``layers.BatchNorm``: flax's statistics and running update).

The optimizer is ``torch.optim.Adam`` (betas 0.9 / 0.999, epsilon 1e-8
outside the square root, bias-corrected), as optax's ``adam``. Optax reads
its schedule at the update count before the update, so step k (from 0)
uses ``lr_init * rate ** (k / decay_steps)``; the trainer sets that rate
before each update.

The heads' inputs are the inference describe's features as plain arrays
(``train.data``): no graph reaches back into the backbone, and no kernel
needs a backward.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn

from roreg_tpu_torch.core.group import get_group
from roreg_tpu_torch.device import resolve_device
from roreg_tpu_torch.dist import multihost
from roreg_tpu_torch.models.et import EquivariantTransformer
from roreg_tpu_torch.models.gf import GroupFeatNetwork
from roreg_tpu_torch.models.rd import RotationDetector
from roreg_tpu_torch.models.rm import RotationCoherenceMatcher
from roreg_tpu_torch.train import checkpoints as ckpt
from roreg_tpu_torch.train import losses as L
from roreg_tpu_torch.utils.metrics_log import ScalarLog
from roreg_tpu_torch.weights import export_variables, init_module_variables, load_variables

__all__ = ["TrainConfig", "TrainState", "Trainer", "make_train_step", "name2metric", "learning_rate", "head_module"]


@dataclass(frozen=True)
class TrainConfig:
    """Per-component hyperparameters; the defaults are the reference's."""

    component: str = "gf"  # gf | rd | rm | et
    group_size: int = 60
    batch_size: int = 32
    lr_init: float = 1e-4
    lr_decay_rate: float = 0.5
    lr_decay_steps: int = 10000
    total_steps: int = 100000
    val_interval: int = 6000
    save_interval: int = 3000
    log_interval: int = 500
    model_dir: str = "checkpoints"

    @staticmethod
    def defaults(component: str, **kw) -> "TrainConfig":
        base = {
            "gf": dict(batch_size=32, lr_init=1e-4, lr_decay_rate=0.5),
            "rd": dict(batch_size=128, lr_init=1e-3, lr_decay_rate=0.8),
            "rm": dict(batch_size=1, lr_init=1e-3, lr_decay_rate=0.8),
            "et": dict(batch_size=32, lr_init=1e-3, lr_decay_rate=0.5),
        }[component]
        base.update(kw)
        return TrainConfig(component=component, **base)


# the validation gate's metric and direction per component
name2metric = {
    "gf": ("whole_recall", 1),
    "rd": ("val_recall", 1),
    "rm": ("pair_ok_rate", 1),
    "et": ("R_error", -1),
}


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """``optax.exponential_decay(lr_init, decay_steps, rate)`` at ``count``
    (no staircase)."""
    return cfg.lr_init * cfg.lr_decay_rate ** (count / cfg.lr_decay_steps)


def head_module(component: str, group_size: int) -> nn.Module:
    """The network a component trains (RM with its training score maps)."""
    group = get_group(group_size)
    if component == "rm":
        return RotationCoherenceMatcher(group, aux_scores=True)
    return {"gf": GroupFeatNetwork, "rd": RotationDetector, "et": EquivariantTransformer}[component](group)


@dataclass
class TrainState:
    """The trained network (on the device), its optimizer, the number of
    updates made, and the frozen networks its forward reads."""

    net: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    group_size: int
    frozen: dict = field(default_factory=dict)

    def variables(self) -> dict:
        """The network's variables in the JAX layout (nested numpy)."""
        return export_variables(self.net)


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}


def make_train_step(cfg: TrainConfig, frozen: dict | None = None, device=None) -> tuple:
    """Returns ``(init_fn, step_fn, eval_fwd)``:

    * ``init_fn(variables=None, seed=0) -> TrainState``: the network from
      ``variables`` (nested numpy in the JAX layout, as the JAX package's
      init gives them) or from the port's numpy initialiser at ``seed``;
    * ``step_fn(state, batch) -> metrics``: one update of ``state`` in
      place; ``batch`` is a dict of arrays (``train.data``'s format);
      metrics are detached tensors (``loss`` and the component's parts);
    * ``eval_fwd(state, batch)``: the component's forward in eval mode,
      without gradients.

    ``frozen`` carries non-trained variables: ``{"gf": ...}`` for ET, whose
    descriptor features come from the frozen GF network (the reference
    freezes GF while ET trains). Runs on CUDA unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    comp = cfg.component
    if comp not in name2metric:
        raise ValueError(comp)
    cayley = torch.as_tensor(get_group(cfg.group_size).cayley, dtype=torch.long, device=dev)
    frozen_nets = {}
    if comp == "et":
        if frozen is None or "gf" not in frozen:
            raise ValueError("ET trains with a frozen GF: pass frozen={'gf': variables}")
        gf = GroupFeatNetwork(get_group(cfg.group_size))
        load_variables(gf, frozen["gf"])
        frozen_nets["gf"] = gf.to(dev).eval().requires_grad_(False)

    def fwd(net: nn.Module, b: dict) -> tuple[torch.Tensor, dict]:
        if comp == "gf":
            # two passes; the second's batch statistics follow the first's
            out0, out1 = net(b["feats0"]), net(b["feats1"])
            return L.gf_loss(out0["inv"], out1["inv"], out0["eqv"], out1["eqv"], b["true_idx"], cayley)
        if comp == "rd":
            loss = L.rd_loss(net(torch.cat([b["feats0"], b["feats1"]])), b["rdiffs"])
            return loss, {"rd_loss": loss}
        if comp == "rm":
            out = net(b["feats0"], b["feats1"], b["keys0"], b["keys1"], b["mask0"], b["mask1"])
            return L.rm_loss(out["scores"], out["scores_other"], b["pairs"], b["pair_mask"],
                             b["unpair0"], b["unpair1"])
        with torch.no_grad():
            eqv0 = frozen_nets["gf"](b["feats0"])["eqv"]
            eqv1 = frozen_nets["gf"](b["feats1"])["eqv"]
        # training aligns by the true index and leaves the quaternion
        # unnormalised, as the reference's ET training does
        q = net(b["feats0"], b["feats1"], eqv0, eqv1, b["true_idx"].long(), normalize=False)
        loss = L.et_loss(q, b["delta_r"])
        return loss, {"et_loss": loss}

    def init_fn(variables: dict | None = None, seed: int = 0) -> TrainState:
        net = head_module(comp, cfg.group_size)
        load_variables(net, variables if variables is not None else init_module_variables(net, seed))
        net.to(dev).train()
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr_init, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(net, opt, 0, cfg.group_size, frozen_nets)

    def step_fn(state: TrainState, batch: dict) -> dict:
        b = _to_device(batch, dev)
        state.net.train()
        for g in state.optimizer.param_groups:
            g["lr"] = learning_rate(cfg, state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = fwd(state.net, b)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def eval_fwd(state: TrainState, batch: dict):
        state.net.eval()
        try:
            with torch.no_grad():
                return fwd(state.net, _to_device(batch, dev))
        finally:
            state.net.train()

    return init_fn, step_fn, eval_fwd


class Trainer:
    """The step loop: log every ``log_interval`` steps (``ScalarLog`` under
    ``<model_dir>/<COMP>/log``), validate every ``val_interval`` steps and
    save ``model_best`` when the gate metric is as good as the best so far,
    save ``model`` every ``save_interval`` steps, and resume from ``model``
    at the saved step."""

    def __init__(
        self,
        cfg: TrainConfig,
        data_iter: Iterator[dict],
        val_fn: Callable[[Any, Any], dict] | None = None,
        frozen: dict | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.primary = multihost.is_primary()  # writes logs and checkpoints (the first of several processes)
        self.data_iter = data_iter
        self.val_fn = val_fn
        self.metric_key, self.greater = name2metric[cfg.component]
        self.best = -np.inf if self.greater > 0 else np.inf
        self.init_fn, self.step_fn, self.eval_fwd = make_train_step(cfg, frozen, device)
        self.state: TrainState | None = None
        self.history: list[dict] = []
        self.scalar_log = ScalarLog(os.path.join(cfg.model_dir, cfg.component.upper(), "log"))

    def _ckpt_dir(self, best: bool = False) -> str:
        return os.path.join(self.cfg.model_dir, self.cfg.component.upper(), "model_best" if best else "model")

    def save(self, best: bool = False) -> None:
        if self.primary:
            ckpt.save_train_state(self._ckpt_dir(best), self.cfg.component, self.state)

    def restore(self, best: bool = False) -> bool:
        if self.state is None:
            self.state = self.init_fn()
        return ckpt.load_train_state(self._ckpt_dir(best), self.cfg.component, self.state)

    def run(self, steps: int | None = None, resume: bool = True) -> dict:
        cfg = self.cfg
        steps = steps or cfg.total_steps
        batch = next(self.data_iter)
        if self.state is None:
            self.state = self.init_fn()
            if resume:
                self.restore()
        last_metrics: dict = {}
        for i in range(self.state.step, steps):
            metrics = self.step_fn(self.state, batch)
            if (i + 1) % cfg.log_interval == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": i + 1, **last_metrics})
                if self.primary:
                    self.scalar_log.write(i + 1, last_metrics, split="train")
            if self.val_fn is not None and (i + 1) % cfg.val_interval == 0:
                val = self.val_fn(self.state, self.eval_fwd)
                v = val[self.metric_key]
                if self.greater * v >= self.greater * self.best:
                    self.best = v
                    self.save(best=True)
                self.history.append({"step": i + 1, **{f"val_{k}": float(x) for k, x in val.items()
                                                       if np.ndim(x) == 0}})
                if self.primary:
                    self.scalar_log.write(i + 1, val, split="val")
            if (i + 1) % cfg.save_interval == 0:
                self.save(best=False)
            if i + 1 < steps:
                batch = next(self.data_iter)
        return {"final_step": steps, "best": self.best, "last": last_metrics}
