"""Model-agnostic ``LayerStack`` adapter protocol (DESIGN.md §8).

The port of :mod:`repro.core.layerstack`.  The planner, the profiling
stage and the hybrid execution engine schedule a *generic* ordered chain
of cut-points:

* :class:`CutMeta` — the per-cut-point quantities the profiling stage needs
  (``flops_fwd`` / ``flops_bwd`` / ``param_count`` / ``param_bytes`` /
  ``act_bytes`` / ``grad_bytes``, all *per sample* where applicable).
* :class:`LayerStack` — the execution + metadata protocol: ``init`` /
  ``apply_segment`` / ``sum_loss`` over a params *list with one entry per
  cut-point* (slicing ``params[:m]`` is what hands a TASK-S/L worker its
  frontend copy).
* :class:`CnnLayerStack` — the CNN adapter.  It delegates every operation
  to the wrapped :class:`~repro_torch.models.cnn.LayeredModel`, so its cut
  meta, and hence profiles and schedules, equal the JAX package's.
* :func:`as_layerstack` — coercion used at every core entry point, so
  call sites may pass a bare ``LayeredModel``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.cnn import LayeredModel

Params = List[Any]   # one entry per cut-point


@dataclasses.dataclass(frozen=True)
class CutMeta:
    """Profiling-stage metadata of one cut-point (paper §III).

    ``flops_fwd`` and the wire sizes are per *sample*; ``param_count`` /
    ``param_bytes`` are absolute.  Two fields are optional with
    model-family defaults:

    * ``flops_bwd`` — ``None`` means "derive from the profiler's
      ``bwd_fwd_ratio``" (the CNN behaviour: the profiler then evaluates
      ``ratio * flops_fwd / flops_per_sec + overhead``).
    * ``grad_bytes`` — backward wire bytes at this cut (the activation
      gradient shipped from worker_o back to a TASK-S/L worker).  ``None``
      means "equal to ``act_bytes``", the paper's §IV-C assumption.

    ``act_elems`` / ``grad_elems`` are the per-sample *element counts*
    of the two crossing tensors — what wire compression operates on
    (``repro_torch.core.wire``): an int8 wire ships ``elems + 4``
    bytes/sample regardless of the source dtype.  ``None`` means "f32
    payload" (the CNN behaviour): ``bytes / 4``.
    """
    name: str
    param_count: int
    flops_fwd: float
    act_bytes: float
    flops_bwd: Optional[float] = None
    param_bytes: Optional[float] = None
    grad_bytes: Optional[float] = None
    act_elems: Optional[float] = None
    grad_elems: Optional[float] = None

    @property
    def resolved_param_bytes(self) -> float:
        return 4.0 * self.param_count if self.param_bytes is None \
            else float(self.param_bytes)

    @property
    def resolved_grad_bytes(self) -> float:
        return float(self.act_bytes) if self.grad_bytes is None \
            else float(self.grad_bytes)

    @property
    def resolved_act_elems(self) -> float:
        return float(self.act_bytes) / 4.0 if self.act_elems is None \
            else float(self.act_elems)

    @property
    def resolved_grad_elems(self) -> float:
        return self.resolved_grad_bytes / 4.0 if self.grad_elems is None \
            else float(self.grad_elems)


class LayerStack:
    """Protocol every schedulable model adapter implements.

    A stack is an ordered chain of ``num_layers`` cut-points.  ``params``
    is always a Python list with exactly one entry per cut-point, so the
    hybrid engine can slice frontend copies (``params[:m_s]``) and
    aggregate per-cut gradients.

    Subclasses must provide:

    * ``name`` — attribute or property; used in profiles and logs.
    * :meth:`cut_meta` — one :class:`CutMeta` per cut-point.
    * :meth:`init` — ``(generator, device) -> params`` list.
    * :meth:`apply_segment` — run cut-points ``start..stop-1`` on batch
      ``x`` (``params`` is the *full* list, indexed absolutely).
    * :meth:`sum_loss` — per-sample-**sum** training loss of the final
      segment output (the hybrid engine divides by the global batch once,
      which is what makes the distributed update exactly batch-B SGD).
    * :meth:`default_sample_bytes` — bytes of one training sample
      (input + label), the profile's ``Q``.
    * :meth:`dummy_batch` — a seeded ``(x, labels)`` batch for
      measurement and smoke paths.
    """

    name: str = "layerstack"

    @property
    def num_layers(self) -> int:
        return len(self.cut_meta())

    def cut_meta(self) -> List[CutMeta]:
        raise NotImplementedError

    def default_sample_bytes(self) -> float:
        raise NotImplementedError

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Params:
        raise NotImplementedError

    def apply_segment(self, params: Params, x: torch.Tensor, start: int,
                      stop: int) -> torch.Tensor:
        raise NotImplementedError

    def sum_loss(self, out: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        raise NotImplementedError

    def dummy_batch(self, generator: torch.Generator, batch: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # ---- conveniences shared by every adapter --------------------------

    def meta_arrays(self) -> dict:
        """``{names, MP, MO, MG}`` profile columns from :meth:`cut_meta`."""
        metas = self.cut_meta()
        return {
            "names": tuple(m.name for m in metas),
            "MP": np.array([m.resolved_param_bytes for m in metas],
                           np.float64),
            "MO": np.array([float(m.act_bytes) for m in metas], np.float64),
            "MG": np.array([m.resolved_grad_bytes for m in metas],
                           np.float64),
        }


@dataclasses.dataclass
class CnnLayerStack(LayerStack):
    """The paper's layered CNNs behind the :class:`LayerStack` protocol.

    Every method delegates to the wrapped :class:`LayeredModel`
    (``grad_bytes`` defaults to ``act_bytes`` and ``flops_bwd`` to the
    profiler ratio, as in the JAX package).
    """
    model: LayeredModel

    @property
    def name(self) -> str:                        # type: ignore[override]
        return self.model.name

    @property
    def num_layers(self) -> int:
        return self.model.num_layers

    def cut_meta(self) -> List[CutMeta]:
        return [CutMeta(name=m.name, param_count=m.param_count,
                        flops_fwd=float(m.flops_fwd),
                        act_bytes=float(m.out_bytes),
                        param_bytes=float(m.param_bytes))
                for m in self.model.layer_meta()]

    def default_sample_bytes(self) -> float:
        # raw uint8 image + int label
        return float(np.prod(self.model.input_shape)) + 4.0

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Params:
        return self.model.init(generator, device)

    def apply_segment(self, params: Params, x: torch.Tensor, start: int,
                      stop: int) -> torch.Tensor:
        return self.model.apply_segment(params, x, start, stop)

    def sum_loss(self, logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, labels.long()[:, None]).sum()

    def dummy_batch(self, generator: torch.Generator, batch: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standard-normal images and uniform labels on the generator's
        device."""
        dev = generator.device
        x = torch.randn((batch,) + tuple(self.model.input_shape),
                        generator=generator, device=dev)
        y = torch.randint(0, self.model.num_classes, (batch,),
                          generator=generator, device=dev)
        return x, y


def as_layerstack(model: Any) -> LayerStack:
    """Coerce a model to the :class:`LayerStack` protocol.

    Accepts an adapter as-is, wraps a bare :class:`LayeredModel`, and
    rejects anything else loudly.
    """
    if isinstance(model, LayerStack):
        return model
    if isinstance(model, LayeredModel):
        return CnnLayerStack(model)
    raise TypeError(
        f"{type(model).__name__} does not implement the LayerStack "
        f"protocol (and is not a LayeredModel); see "
        f"repro_torch/core/layerstack.py")
