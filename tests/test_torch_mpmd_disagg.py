"""The disaggregated-serving graph of the port's MPMD tooling
(``paddle_tpu_torch.distributed.mpmd_graph.disagg_graph``) against the JAX
package's: request r prefills on worker r % P and migrates its KV pages
to decode worker P + r % D, the decode pool bounding the migrations in
flight on a route. The events, messages, dependencies, stages and channel
capacities (``to_dict()``) equal JAX's, and the port's lint
(``analysis.mpmd_lint.check_graph``) finds the graph clean; a decode
worker that admits the migrations out of order is flagged as JAX's lint
flags it.

Tolerance: exact (graph structure).
"""
import pytest

from paddle_tpu.analysis.mpmd_lint import check_graph as jax_check_graph
from paddle_tpu.distributed import mpmd_graph as jmg
from paddle_tpu_torch.analysis.mpmd_lint import check_graph
from paddle_tpu_torch.distributed import mpmd_graph as mg


@pytest.mark.parametrize("P,D,N", [(2, 2, 6), (1, 2, 4), (3, 1, 5)])
def test_disagg_graph_matches_jax_and_lints_clean(P, D, N):
    want = jmg.disagg_graph(P, D, N)
    got = mg.disagg_graph(P, D, N)
    assert got.to_dict() == want.to_dict()
    assert got.n_stages == P + D and got.n_events() == 2 * N
    assert got.subject == f"mpmd(disagg, P={P}, D={D}, reqs={N})"
    assert not check_graph(got), check_graph(got).format()
    # the port's graph round-trips through the JAX one's serial form
    assert mg.MpmdGraph.from_dict(want.to_dict()).to_dict() == \
        got.to_dict()


def test_disagg_graph_options_match_jax():
    kw = dict(kv_shape=(16, 128), act_dtype="bfloat16", pool_slots=1,
              subject="serving")
    got = mg.disagg_graph(2, 2, 6, **kw)
    assert got.to_dict() == jmg.disagg_graph(2, 2, 6, **kw).to_dict()
    assert got.subject == "serving"
    assert set(got.channel_capacity.values()) == {1}


def test_out_of_order_admission_is_flagged_as_jax_flags_it():
    """A decode worker admitting the migrations in reverse order pairs
    each send with another request's KV: the port's lint finds the
    unmatched hand-off, with JAX's rules and messages."""
    def reversed_decode(mod):
        g = mod.disagg_graph(1, 1, 4, pool_slots=1)
        g.programs[1].reverse()
        return g
    got = check_graph(reversed_decode(mg))
    want = jax_check_graph(reversed_decode(jmg))
    assert "mpmd.unmatched-p2p" in got.rules()
    assert got.rules() == want.rules()
    assert [f.message for f in got] == [f.message for f in want]
