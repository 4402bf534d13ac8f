"""The Adam / AdamW update as one pass over the parameters.

No TPU kernel stands behind this one: the JAX ``TrainStep`` traces
``apply_gradients_pytree`` into its one jitted step
(``paddle_tpu/jit/api.py:501-509``), and XLA fuses each parameter's
update into one pass. The port's counterpart of that fusion is
``csrc/fused_adam.cu``: one launch updates every parameter of one dtype
combination, then a second, one thread a parameter, advances the beta
powers (every block of a parameter has read them by then).

- ``adam_update_plain`` is the plain version, the per-tensor rule of
  ``optimizers.Adam._update`` / ``AdamW._update`` / ``_adam_core``
  (about fifteen elementwise ops, each a pass over f32 tensors: ~150
  bytes of device memory traffic a parameter). The CPU runs it, the tests
  hold the JAX rule to it, and the card runs it only on the "plain"
  route.
- ``fused_adam_launch`` launches the kernel: per element it reads the f32
  parameter and gradient and the two moments and writes the parameter
  and the moments, 20 bytes a parameter with bf16 moments (28 with f32;
  amsgrad's ``moment2_max`` adds 4 / 8, so 24 / 36): that bounds it on an
  H100.
  Its arithmetic is the plain version's, operation for operation and in
  its order, with the rounding intrinsics (``__fmul_rn``, ``__fadd_rn``,
  ``__fdiv_rn``, ``__fsqrt_rn``, so nvcc contracts no FMA) and the
  constants rounded from the same Python doubles: on the card the two
  are bit-equal.
- ``adam_update`` is the wrapper the optimizers call: it takes each
  parameter's route (``adam_update_route``), launches the kernel once for
  the "fused" ones and runs the plain version on the others, and counts
  them in ``kernels.optimizer.adam_fused`` (launches) and
  ``kernels.optimizer.adam_plain`` (tensors). A failed build or launch
  raises; nothing falls back to the plain loop.

The launch reads two device tables: the parameters' pointers (parameter,
gradient, moment1, moment2, moment2_max, beta1_pow, beta2_pow, numel),
uploaded at each launch through pinned memory (a train step's gradients
are new tensors every step), and the chunks (parameter index, first
element, count) that drive the blocks, cached by the parameters' sizes.
"""
from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Sequence

import torch

from .. import monitor
from . import _build

#: elements a block updates (256 threads x 8-element vectors x 4)
ADAM_CHUNK = 8192
#: dtype codes shared with csrc/fused_adam.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: decay modes shared with csrc/fused_adam.cu: none, AdamW's decoupled
#: ``p *= 1 - lr * coeff`` before the step, Adam's L2 ``g += coeff * p``
DECAYS = {"none": 0, "decoupled": 1, "l2": 2}
_PARAM_FIELDS = 8

_chunk_tables: "collections.OrderedDict[tuple, torch.Tensor]" = \
    collections.OrderedDict()


def adam_update_route(device, param_dtype, grad_dtype, moment_dtype) -> str:
    """The route of one parameter's update, the rule the C entry applies
    (``fused_adam_route`` in ``csrc/fused_adam.cu``): "fused" for a CUDA
    parameter in float32 with a float32 gradient and float32 or bfloat16
    moments; "plain" otherwise (the CPU, a bf16/fp16 parameter under
    ``multi_precision``, a gradient of another dtype, fp16 moments)."""
    if torch.device(device).type == "cuda" and param_dtype == torch.float32 \
            and grad_dtype == torch.float32 \
            and moment_dtype in (torch.float32, torch.bfloat16):
        return "fused"
    return "plain"


def adam_core_plain(p, g, state, lr, beta1, beta2, epsilon, amsgrad):
    """In place: p -= lr_t * m1 / denom; moments and beta powers advanced
    (``_adam_core``, ``paddle_tpu/optimizer/optimizers.py:139``). ``lr``
    is a 0-d f32 tensor on ``p``'s device."""
    g32 = g.float()
    m1 = beta1 * state["moment1"].float() + (1 - beta1) * g32
    m2 = beta2 * state["moment2"].float() + (1 - beta2) * g32 * g32
    b1p, b2p = state["beta1_pow"], state["beta2_pow"]
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    if amsgrad:
        m2m = torch.maximum(state["moment2_max"].float(), m2)
        denom = torch.sqrt(m2m) + epsilon * torch.sqrt(1 - b2p)
        state["moment2_max"].copy_(m2m)
    else:
        denom = torch.sqrt(m2) + epsilon * torch.sqrt(1 - b2p)
    p.sub_((lr_t * m1 / denom).to(p.dtype))
    state["moment1"].copy_(m1)
    state["moment2"].copy_(m2)
    b1p.mul_(beta1)
    b2p.mul_(beta2)


def adam_update_plain(p, g, state, lr, beta1, beta2, epsilon, amsgrad,
                      decay, coeff):
    """The plain version of one parameter's update: AdamW's decay
    (``p *= 1 - lr * coeff``, :181-184) or Adam's L2 (``g + coeff * p``,
    ``_apply_l2``), then ``adam_core_plain``."""
    if coeff and decay == "decoupled":
        p.mul_(1.0 - lr * coeff)
    elif coeff and decay == "l2":
        g = g + coeff * p
    adam_core_plain(p, g, state, lr, beta1, beta2, epsilon, amsgrad)


def adam_chunks(numels: Sequence[int], device) -> torch.Tensor:
    """The chunk table [n_chunks, 3] int64 (parameter index, first
    element, count) for parameters of these sizes, cached by them: every
    chunk but a parameter's last holds ADAM_CHUNK elements, and each
    starts at a multiple of ADAM_CHUNK, so its 8-element vectors stay
    16-byte aligned."""
    key = (tuple(int(n) for n in numels), str(device))
    table = _chunk_tables.get(key)
    if table is not None:
        _chunk_tables.move_to_end(key)
        return table
    rows = [(i, s, min(ADAM_CHUNK, n - s)) for i, n in enumerate(key[0])
            for s in range(0, n, ADAM_CHUNK)]
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 3).to(device)
    _chunk_tables[key] = table
    while len(_chunk_tables) > 8:
        _chunk_tables.popitem(last=False)
    return table


class AdamTables(NamedTuple):
    """What one launch reads: the parameter table on the card ([n, 8]
    int64: parameter, gradient, moment1, moment2, moment2_max, beta1_pow,
    beta2_pow, numel), the chunk table, and the moment dtype."""
    params: torch.Tensor
    chunks: torch.Tensor
    moment_dtype: torch.dtype


def _route_error(p, g, mdt):
    return ValueError(
        f"fused_adam_launch: {p.device} {p.dtype} parameter, {g.dtype} "
        f"gradient, {mdt} moments: the kernel takes CUDA float32 "
        f"parameters and gradients with float32 or bfloat16 moments "
        f"(adam_update_route)")


def adam_tables(params, grads, states, amsgrad) -> AdamTables:
    """Check every tensor, at every launch, and build the tables of one
    launch: one pass over the parameters raises on anything the kernel
    does not take (its wrapper never routes around it) and collects each
    parameter's row. The parameter table goes up on the current stream
    from pinned memory (the caching host allocator keeps the pinned block
    until the copy has run)."""
    if not params:
        raise ValueError("fused_adam_launch: no parameters")
    f32 = torch.float32
    dev = params[0].device
    mdt = states[0]["moment1"].dtype
    if adam_update_route(dev, f32, f32, mdt) != "fused":
        raise _route_error(params[0], grads[0], mdt)
    slots = ("moment1", "moment2") + (("moment2_max",) if amsgrad else ())
    rows = []
    for p, g, st in zip(params, grads, states):
        shape = p.shape
        if p.dtype != f32 or g.dtype != f32:
            raise _route_error(p, g, st["moment1"].dtype)
        if p.device != dev or g.device != dev:
            raise ValueError("fused_adam_launch: tensors on several devices")
        if not p.is_contiguous() or not g.is_contiguous() \
                or g.numel() != p.numel():
            raise ValueError(
                f"fused_adam_launch: a parameter of {p.numel()} elements "
                f"and its gradient of {g.numel()}: the kernel takes "
                f"contiguous parameters and gradients of one size")
        row = [p.data_ptr(), g.data_ptr()]
        for name in slots:
            t = st[name]
            if t.dtype != mdt:
                if adam_update_route(dev, f32, f32, t.dtype) != "fused":
                    raise _route_error(p, g, t.dtype)
                raise ValueError("fused_adam_launch: one launch takes one "
                                 "moment dtype")
            if t.device != dev:
                raise ValueError(
                    "fused_adam_launch: tensors on several devices")
            if not t.is_contiguous() or t.shape != shape:
                raise ValueError("fused_adam_launch: parameters and "
                                 "moments must be contiguous and of one "
                                 "shape")
            row.append(t.data_ptr())
        if not amsgrad:
            row.append(0)
        for name in ("beta1_pow", "beta2_pow"):
            t = st[name]
            if t.dtype != f32 or t.numel() != 1 or t.device != dev:
                raise ValueError("fused_adam_launch: beta powers must be "
                                 "f32 scalars on the parameters' device")
            row.append(t.data_ptr())
        row.append(p.numel())
        rows.append(row)
    host = torch.tensor(rows, dtype=torch.int64).reshape(-1, _PARAM_FIELDS)
    # the device table may be freed as soon as the launch is queued: the
    # caching allocator hands its block only to work queued after it on
    # the same stream
    return AdamTables(host.pin_memory().to(dev, non_blocking=True),
                      adam_chunks([r[-1] for r in rows], dev), mdt)


def fused_adam_launch(params: List[torch.Tensor], grads: List[torch.Tensor],
                      states: List[Dict[str, torch.Tensor]], lr: float,
                      beta1: float, beta2: float, epsilon: float, *,
                      amsgrad: bool, decay: str = "none", coeff: float = 0.0,
                      tables: AdamTables = None) -> None:
    """Launch the kernel of ``csrc/fused_adam.cu`` on CUDA tensors (it
    raises on anything else, a CPU tensor included): every parameter and
    its state updated in place, then the beta powers advanced. ``tables``
    (default: ``adam_tables`` of the tensors) lets ``chip_smoke.py`` time
    the launch alone and run its negative control. Counts one launch on
    ``fused_adam_launch.launches``."""
    if tables is None:
        tables = adam_tables(params, grads, states, amsgrad)
    lib = _build.load("fused_adam")
    if not coeff:        # the plain version skips a zero decay altogether
        decay = "none"
    c = float(coeff) if decay != "none" else 0.0
    _build.check(lib.fused_adam_launch(
        tables.params.data_ptr(), tables.chunks.data_ptr(),
        tables.chunks.shape[0], tables.params.shape[0],
        _CODES[torch.float32], _CODES[torch.float32],
        _CODES[tables.moment_dtype], int(bool(amsgrad)), DECAYS[decay],
        float(lr), float(beta1), float(1 - beta1), float(beta2),
        float(1 - beta2), float(epsilon), c,
        _build.stream(tables.params.device)), "fused_adam_launch")
    fused_adam_launch.launches += 1


fused_adam_launch.launches = 0


def adam_update(items, lr: float, beta1: float, beta2: float,
                epsilon: float, amsgrad: bool, decay: str,
                coeff: float) -> None:
    """Update every (tensor, gradient, state, model parameter dtype) item
    in place at learning rate ``lr``: the "fused" ones in one kernel
    launch, the others by the plain version, one tensor at a time."""
    fused, plain = [], []
    for p, g, st, pdt in items:
        route = adam_update_route(p.device, pdt, g.dtype,
                                  st["moment1"].dtype)
        if route == "fused":
            # the kernel reads a gradient as a flat array: a transposed
            # view (the gradient of a weight used as w.t()) is copied
            fused.append((p, g if g.is_contiguous() else g.contiguous(), st))
        else:
            plain.append((p, g, st))
    if fused:
        ps, gs, sts = zip(*fused)
        fused_adam_launch(list(ps), list(gs), list(sts), lr, beta1, beta2,
                          epsilon, amsgrad=amsgrad, decay=decay,
                          coeff=coeff)
        monitor.counter("kernels.optimizer.adam_fused").increase()
    lr_t = None
    for p, g, st in plain:
        if lr_t is None or lr_t.device != p.device:
            lr_t = torch.tensor(float(lr), dtype=torch.float32,
                                device=p.device)
        adam_update_plain(p, g, st, lr_t, beta1, beta2, epsilon, amsgrad,
                          decay, coeff)
    if plain:
        monitor.counter("kernels.optimizer.adam_plain").increase(len(plain))
