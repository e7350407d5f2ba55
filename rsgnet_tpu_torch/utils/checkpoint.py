"""Checkpoints: save, resume and eval weights (the port of the JAX
package's ``utils/checkpoint.py``).

Each epoch writes ``checkpoint.pt`` ({epoch, batch_in_epoch, step, model,
optimizer, optimizer_name, param_names, perf, best_perf}; ``model`` is the
model's state dict, weights and BatchNorm statistics, ``optimizer`` the
optimizer's)
and, on a best epoch, ``model_best.pt`` ({model, perf, epoch}), both with
``torch.save`` and read with ``torch.load(weights_only=True)``.

- ``perf`` is the epoch's metric (0.0 on an epoch that did not validate)
  and ``best_perf`` the running best, so a resumed run never overwrites
  ``model_best.pt`` with a worse model.
- ``batch_in_epoch`` > 0 marks a mid-epoch (preemption) checkpoint: that
  many steps of ``epoch`` are applied, and ``auto_resume`` re-enters the
  epoch there.
- Writes go to a temporary file and then ``os.replace``, so a crash
  mid-write leaves the previous checkpoint whole.
- The payload is copied to the host before ``save`` returns: the train
  step updates parameters and Adam moments in place, so a payload holding
  references would let an asynchronous write record a later step.
- The optimizer's state dict keys its moments by parameter index. The
  payload records the parameter names in that order, and
  ``load_checkpoint`` restores the moments only onto the same names in
  the same order.

``load_weights`` loads eval weights from this package's ``.pt`` (a
checkpoint, a best file or a bare state dict), from the JAX package's
``.msgpack`` (``utils/msgpack.py`` + ``utils/convert.py``) or from a
reference ``.pth`` (``utils/torch_convert.py``), deciding by what the file
holds, not by its suffix.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import torch

CKPT_NAME = "checkpoint.pt"
BEST_NAME = "model_best.pt"

log = logging.getLogger("rsgnet_tpu_torch.checkpoint")


def _host_copy(obj):
    """``obj`` with every tensor copied to the host (a new CPU tensor even
    for one already there); containers are rebuilt."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _param_names(model):
    return [name for name, _ in model.named_parameters()]


def _snapshot(state, epoch: int, perf: float, best_perf: float | None,
              batch_in_epoch: int = 0) -> dict:
    """The checkpoint payload, every tensor on the host by the time it
    returns."""
    return {
        "epoch": int(epoch),
        "batch_in_epoch": int(batch_in_epoch),
        "step": int(state.step),
        "model": _host_copy(state.model.state_dict()),
        "optimizer": _host_copy(state.optimizer.state_dict()),
        "optimizer_name": type(state.optimizer).__name__,
        "param_names": _param_names(state.model),
        "perf": float(perf),
        "best_perf": float(perf if best_perf is None else best_perf),
    }


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_payload(out_dir: str, payload: dict, is_best: bool) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, CKPT_NAME)
    _atomic_save(payload, path)
    if is_best:
        _atomic_save({"model": payload["model"], "perf": payload["perf"],
                      "epoch": payload["epoch"]},
                     os.path.join(out_dir, BEST_NAME))
    return path


def save_checkpoint(out_dir: str, state, epoch: int, perf: float,
                    is_best: bool, best_perf: float | None = None,
                    batch_in_epoch: int = 0) -> str:
    """Write ``state`` (``core/train.py::TrainState``) to
    ``out_dir/checkpoint.pt`` (and ``model_best.pt`` when ``is_best``).
    Returns the checkpoint's path."""
    return _write_payload(out_dir, _snapshot(state, epoch, perf, best_perf,
                                             batch_in_epoch), is_best)


class AsyncCheckpointer:
    """``save_checkpoint`` with the file write on a background thread
    (TRAIN.ASYNC_CHECKPOINT). The copy to the host stays on the caller's
    thread (see ``_snapshot``); ``torch.save`` and the rename overlap the
    next epoch. At most one write is in flight: ``save`` joins the previous
    one first, so files land in order. ``close`` joins the last write and
    stops the thread."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt")
        self._pending = None

    def save(self, out_dir: str, state, epoch: int, perf: float,
             is_best: bool, best_perf: float | None = None,
             batch_in_epoch: int = 0) -> None:
        payload = _snapshot(state, epoch, perf, best_perf, batch_in_epoch)
        self.wait()
        self._pending = self._pool.submit(_write_payload, out_dir, payload,
                                          is_best)

    def wait(self):
        """Join the in-flight write; re-raises its exception, if any."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def _load(path: str, mmap: bool = False):
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap)


def peek_checkpoint(path: str) -> dict:
    """{'epoch', 'perf', 'best_perf', 'batch_in_epoch'} of a checkpoint
    file, without a train state (its tensors are mapped, not read)."""
    raw = _load(path, mmap=True)
    return {"epoch": int(raw.get("epoch", 0)),
            "perf": float(raw.get("perf", 0.0)),
            "best_perf": float(raw.get("best_perf", raw.get("perf", 0.0))),
            "batch_in_epoch": int(raw.get("batch_in_epoch", 0))}


def _restore_optimizer(optimizer, model, raw, path):
    """Load the payload's optimizer state into ``optimizer`` when it was
    written by the same optimizer over ``model``'s parameters in the same
    order; otherwise warn and leave the optimizer fresh, so no moment ever
    lands on another parameter."""
    names = _param_names(model)
    if (raw.get("optimizer_name") != type(optimizer).__name__
            or raw.get("param_names") != names):
        log.warning("checkpoint %s: its optimizer state (%s over %d "
                    "parameters) does not fit %s over this model's %d in "
                    "order; resuming weights and epoch with a fresh "
                    "optimizer state", path, raw.get("optimizer_name"),
                    len(raw.get("param_names") or ()),
                    type(optimizer).__name__, len(names))
        return
    optimizer.load_state_dict(raw["optimizer"])


def load_checkpoint(path: str, state) -> Tuple[object, int, float, int]:
    """Restore ``state`` in place from ``path``: weights, BatchNorm
    statistics, the optimizer's state, ``step`` and the learning rate at
    that step. Returns (state, epoch, best_perf, batch_in_epoch). A best
    file (no optimizer state) restores the weights alone."""
    raw = _load(path)
    state.model.load_state_dict(raw["model"], strict=True)
    if "optimizer" in raw:
        _restore_optimizer(state.optimizer, state.model, raw, path)
    if "step" in raw:
        state.step = int(raw["step"])
    state.set_lr()
    best = raw.get("best_perf", raw.get("perf", 0.0))
    return (state, int(raw.get("epoch", 0)), float(best),
            int(raw.get("batch_in_epoch", 0)))


def auto_resume(out_dir: str, state):
    """(state, begin_epoch, best_perf, start_batch), restored from
    ``out_dir/checkpoint.pt`` when it exists: an epoch-boundary checkpoint
    resumes at the next epoch, a mid-epoch one re-enters its epoch at the
    recorded batch."""
    path = os.path.join(out_dir, CKPT_NAME)
    if not os.path.exists(path):
        return state, 0, 0.0, 0
    state, epoch, perf, batch = load_checkpoint(path, state)
    if batch > 0:
        return state, epoch, perf, batch
    return state, epoch + 1, perf, 0


def load_weights(cfg, model, model_file: str):
    """Load eval weights into ``model`` (on the CPU, from
    ``models.get_pose_net(cfg)``) and return it.

    - "" -> the seeded init (``models.init_weights``, seed 0);
    - a flax msgpack map holding ``params`` and ``batch_stats`` -> the JAX
      package's checkpoint;
    - a torch file holding this model's state dict, bare or under
      ``model`` -> this package's ``.pt``;
    - a torch file holding reference ``pose_hrnet`` or ``pose_resnet``
      names (``conv1.weight`` ...), optionally under ``state_dict`` and
      with ``module.`` prefixes -> the backbone from it, the rest (the RSG
      head) from the seeded init;
    - for ``pose_vit``, a torch file holding a released ViTPose model's
      names (``backbone.pos_embed`` ...) -> every tensor of it, strictly
      (``torch_convert.py::vit_key_map``); a msgpack file raises.

    Any other file raises ``ValueError``."""
    from rsgnet_tpu_torch.models import init_weights
    from rsgnet_tpu_torch.utils.msgpack import (looks_like_msgpack_map,
                                                msgpack_restore)
    if not model_file:
        return init_weights(model, seed=0)
    with open(model_file, "rb") as f:
        head = f.read(1)
    own = set(model.state_dict())
    if looks_like_msgpack_map(head):
        if cfg.MODEL.NAME == "pose_vit":
            raise ValueError(f"{model_file}: a msgpack file holds the JAX "
                             f"package's weights, and the JAX package has "
                             f"no pose_vit model")
        from rsgnet_tpu_torch.utils.convert import (flatten_variables,
                                                    state_dict_from_flax)
        with open(model_file, "rb") as f:
            raw = msgpack_restore(f.read())
        if not (isinstance(raw, dict) and "params" in raw
                and "batch_stats" in raw):
            raise ValueError(f"{model_file}: a msgpack file without flax "
                             f"params and batch_stats")
        sd = state_dict_from_flax(flatten_variables(
            {"params": raw["params"], "batch_stats": raw["batch_stats"]}),
            cfg)
        model.load_state_dict(sd, strict=True)
        return model
    raw = _load(model_file)
    if isinstance(raw, dict) and isinstance(raw.get("model"), dict) \
            and set(raw["model"]) == own:
        model.load_state_dict(raw["model"], strict=True)
        return model
    if isinstance(raw, dict) and set(raw) == own:
        model.load_state_dict(raw, strict=True)
        return model
    from rsgnet_tpu_torch.utils.torch_convert import (backbone_prefix,
                                                      convert_state_dict,
                                                      strip_module_prefix)
    ref = strip_module_prefix(raw) if isinstance(raw, dict) else {}
    if cfg.MODEL.NAME == "pose_vit" and "backbone.pos_embed" in ref:
        model.load_state_dict(convert_state_dict(cfg, ref), strict=True)
        return model
    if "conv1.weight" in ref and "final_layer.weight" in ref:
        init_weights(model, seed=0)
        sd = convert_state_dict(cfg, ref, backbone_prefix(model))
        model.load_state_dict(sd, strict=False)
        return model
    raise ValueError(f"{model_file}: neither this package's state dict "
                     f"(bare or under 'model'), nor a flax msgpack "
                     f"checkpoint, nor a reference pose_hrnet, pose_resnet "
                     f"or ViTPose state dict")
