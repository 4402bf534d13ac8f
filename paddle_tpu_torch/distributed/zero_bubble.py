"""Zero-bubble pipeline schedules: the input's gradient apart from the
weights' (counterpart of ``paddle_tpu/distributed/zero_bubble.py``;
reference passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:62).

The reference splits each ``matmul_grad`` into its input-grad and
weight-grad halves and schedules the weight-grad ops into the drain
bubble; the JAX package slices the vjp jaxpr the same way. In torch the
split is made on the stage's autograd graph, each node running once:

- the graph's nodes on a path from the output to the stage input are
  the B half's; a node of it with an edge to a weight (a matmul's
  ``MmBackward``, a norm's ``MulBackward``) is a frontier node;
- the B half (``backward_x``) runs ``torch.autograd.backward`` into the
  stage input only, with ``retain_graph``: the engine computes no
  weight-side output of a frontier node (a matmul computes dX, not dW),
  and a hook on each frontier node keeps the gradient it received;
- the W half (``WeightHalf.run``) starts the engine at each frontier
  node with that gradient, into its weights only: each node computes just
  its weight-side outputs (dW = Xᵀ dY), and no node of the B half runs
  again.

Weights the W half cannot take alone are taken in B: a weight reached
from two frontier nodes (a root at one would run the B half's nodes
between them again) and a weight of a custom ``autograd.Function``
(whose backward computes every input's gradient at once: the fused
loss's head). A stage whose input takes no gradient (stage 0's token
ids) has no B half: its W half is the whole backward.

``split_backward`` packages the two halves for one stage function;
``pipeline.stage_backward`` and ``pipeline.stage_weights`` run them at
the bwd and w events of the ZBH1 / ZBVPP graphs, the w events where
``mpmd_graph`` puts them (the drain bubble). ``zb_local`` /
``zbvpp_local`` are those schedules' rank-local functions.
``zb_schedule_info`` and ``zbvpp_schedule_info`` are the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch.autograd.graph import GradientEdge, get_gradient_edge


def _post_order(root):
    """The autograd nodes under ``root``, each after its children."""
    order, seen, stack = [], set(), [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if node in seen:
            continue
        seen.add(node)
        stack.append((node, True))
        for child, _ in node.next_functions:
            if child is not None and child not in seen:
                stack.append((child, False))
    return order


def _frontier(out, x, params):
    """({frontier node: [its W-half weights]}, [the weights B takes]) of
    the graph of ``out``; ``x`` the stage input (a leaf)."""
    x_node = get_gradient_edge(x).node
    leaf = {get_gradient_edge(p).node: i for i, p in enumerate(params)}
    to_x, to_w = {}, {}
    order = _post_order(out.grad_fn)
    for node in order:
        kids = [c for c, _ in node.next_functions if c is not None]
        to_x[node] = node is x_node or any(to_x[c] for c in kids)
        ws = {leaf[node]} if node in leaf else set()
        for c in kids:
            ws |= to_w[c]
        to_w[node] = frozenset(ws)
    front, owners = {}, {}
    for node in order:
        if not to_x[node]:
            continue
        ws = set()
        for c, _ in node.next_functions:
            if c is not None and not to_x[c]:
                ws |= to_w[c]
        if ws:
            front[node] = ws
            for i in ws:
                owners.setdefault(i, []).append(node)
    in_b = {i for i, nodes in owners.items()
            if len(nodes) > 1 or any(isinstance(
                n, torch.autograd.function.BackwardCFunction)
                for n in nodes)}
    plan = {node: [params[i] for i in sorted(ws - in_b)]
            for node, ws in front.items()}
    return ({n: ws for n, ws in plan.items() if ws},
            [params[i] for i in sorted(in_b)])


class WeightHalf:
    """The W half: the gradient each frontier node received in B (the
    graph kept), or, with no B half, the whole backward. ``run()``
    accumulates the weights' gradients in their ``.grad``, each frontier
    node computing its weight side only, and frees the graph."""

    def __init__(self, out, dy, plan, grads):
        self.out, self.dy, self.plan, self.grads = out, dy, plan, grads

    def run(self):
        if self.plan is None:           # no B half: the whole backward
            if self.grads:
                torch.autograd.backward(self.out, self.dy,
                                        inputs=self.grads)
        else:
            for node, ws in self.plan.items():
                got = self.grads.get(node)
                if got is None:
                    continue
                idx = [i for i, g in enumerate(got) if g is not None]
                if idx:
                    torch.autograd.backward(
                        [GradientEdge(node, i) for i in idx],
                        [got[i] for i in idx], inputs=ws,
                        retain_graph=True)
        self.out = self.dy = self.plan = self.grads = None


def backward_x(out, x, dy=None, params: Sequence[torch.Tensor] = ()):
    """The B half: ``(d out / d x, the W half's WeightHalf)``; dx is
    None when x takes no gradient. The weights B takes (``_frontier``)
    accumulate in their ``.grad``; the graph is kept for the W half."""
    params = [p for p in params if p.requires_grad]
    if not (isinstance(x, torch.Tensor) and x.requires_grad):
        return None, WeightHalf(out, dy, None, params)
    plan, in_b = _frontier(out, x, params)
    grads = {}
    hooks = [node.register_prehook(
        lambda g, node=node: grads.__setitem__(node, g)) for node in plan]
    x.grad = None
    try:
        torch.autograd.backward(out, dy, inputs=[x] + in_b,
                                retain_graph=True)
    finally:
        for h in hooks:
            h.remove()
    return x.grad, WeightHalf(out, dy, plan, grads)


def split_backward(f: Callable, params: Dict[str, torch.Tensor], x, dy,
                   nondiff: tuple = ()):
    """The backward of ``f(params, x, *nondiff) -> y`` at cotangent
    ``dy``, in two halves over one forward:

    * ``bwd_x() -> (dx, stash)``: the input's gradient, and what the
      weight half needs (a ``WeightHalf``);
    * ``bwd_w(stash) -> {name: dparam}``: the weights' gradients.

    Together they give what one ``torch.autograd.grad`` over (x, params)
    gives, every node of the graph run once. (The JAX function also
    returns the stash's shapes: here the stash holds the kept graph.)"""
    names = sorted(params)
    leaves = {n: params[n].detach().requires_grad_(params[n].requires_grad)
              for n in names}
    xl = x.detach().requires_grad_(x.is_floating_point())
    with torch.enable_grad():
        y = f(leaves, xl, *nondiff)

    def bwd_x():
        return backward_x(y, xl, dy, [leaves[n] for n in names])

    def bwd_w(stash):
        stash.run()
        return {n: leaves[n].grad for n in names}

    return bwd_x, bwd_w


def zb_schedule_info(n_stages: int, n_micro: int):
    """Wall/bubble accounting in forward-units (F=1, B-dx=2, W=1).

    Forward phase: M+S-1 lockstep ticks at 1 unit. Backward phase:
    2M+S-1 ticks — while any stage runs a B (dx) tick the tick costs 2
    units (t in [0, M+S-2]); the remaining M ticks are W-only at 1 unit,
    and every stage's weight-grad work hides under other stages' B ticks
    wherever the schedule overlaps. Useful work is 4M units per stage
    (F:1 + B:2 + W:1 per microbatch).
    """
    S, M = n_stages, n_micro
    wall = (M + S - 1) + 2 * (M + S - 1) + M
    useful = 4 * M
    return {"wall_units": wall, "useful_units": useful,
            # forward-phase schedule ticks (one ppermute hop each) —
            # the cross-schedule comparable count shard_lint's cost
            # model uses; wall_units above are weighted COST units
            # (B ticks count 2), not hops
            "ticks": M + S - 1,
            "bubble_fraction": (wall - useful) / wall}


def zbvpp_schedule_info(n_stages: int, n_micro: int, vpp_degree: int):
    """Wall/bubble accounting in forward-units (chunk F=1/V, B=2/V,
    W=1/V). Forward: VM+S-1 lockstep ticks; backward: B sub-phase spans
    VM+S-1 ticks at 2/V, then the residual W ticks at 1/V. Useful work
    per stage = 4M units."""
    S, M, V = n_stages, n_micro, vpp_degree
    t_total = 2 * V * M + S - 1
    wall = ((V * M + S - 1)             # fwd ticks @ 1/V
            + 2 * (V * M + S - 1)       # any-B ticks @ 2/V
            + (t_total - (V * M + S - 1))) / V  # W-only tail @ 1/V
    useful = 4 * M
    return {"wall_units": wall, "useful_units": useful,
            # forward-phase schedule ticks (see zb_schedule_info)
            "ticks": V * M + S - 1,
            "bubble_fraction": (wall - useful) / wall}


def zb_local(block_f: Callable, n_stages: int, n_micro: int, group=None):
    """The ZBH1 schedule's rank-local function ``local_fn(stage_params,
    xs)``: the GPipe forward, then the backward of ``zb_graph``: each
    microbatch's B (input gradient) on the reverse ring, its W (weight
    gradients) M ticks later, in the drain bubble."""
    from .mpmd_graph import zb_graph
    from .pipeline import _check_stages, _run_schedule
    S = _check_stages(group, n_stages)
    graph = zb_graph(S, int(n_micro))

    def local_fn(stage_params, xs):
        return _run_schedule(graph, block_f, [stage_params], xs, group,
                             False)

    return local_fn


def zbvpp_local(block_f: Callable, n_stages: int, n_micro: int,
                vpp_degree: int, group=None):
    """The ZBVPP schedule's rank-local function ``local_fn(chunk_params,
    xs)``: the interleaved forward, then ``zbvpp_graph``'s backward (B
    per (chunk, microbatch) on the reverse ring with the wrap, W after)."""
    from .mpmd_graph import zbvpp_graph
    from .pipeline import _check_stages, _run_schedule
    S = _check_stages(group, n_stages)
    M, V = int(n_micro), int(vpp_degree)
    if M < S:
        raise ValueError(
            f"interleaved schedule needs accumulate_steps >= pp degree "
            f"({M} < {S})")
    graph = zbvpp_graph(S, M, V)

    def local_fn(chunk_params: List[Dict], xs):
        return _run_schedule(graph, block_f, list(chunk_params), xs, group,
                             False)

    return local_fn
