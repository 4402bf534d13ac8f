"""paddle_tpu_torch.analysis: the linters (counterpart of
``paddle_tpu/analysis``). Only the MPMD part is here yet:
``findings`` (the Finding / Report model) and ``mpmd_lint`` (the model
checker ``distributed.mpmd_runtime.MpmdDriver`` runs on every graph it is
given). The AST, jaxpr, shard and hot-path linters, the cost model and
the planner come with the analysis slice of the port (ROADMAP item 4);
until then ``analysis`` is not a top-level name of the package.
"""
from .findings import MPMD_RULES, Finding, Report  # noqa: F401
from .mpmd_lint import check_graph, emit_mpmd, lint_mpmd  # noqa: F401
