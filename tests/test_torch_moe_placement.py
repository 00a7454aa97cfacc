"""The MoE sort dispatch and the token embedding placed on a mesh
(``train.jit_sharded``), held to the unplaced port — the ``placement``
part of ``repro_torch.launch.meshcheck``, run once for the module: four
gloo ranks and one process of fake-world traces at once.

  * Routing groups fewer than the ranks that split the rows
    (``layers.in_groups`` / ``steps.placed_groups``): deepseek-v2-236b's
    smoke step (8 experts) with its 4 x 40 tokens routed in 2 groups of
    80 on a (4, 1) mesh, each group's rows on two ranks. The step equals
    the plain one, and on a fake (4, 1) mesh each rank computes the one
    group its rows belong to: half the unplaced flops of the layer, where
    a view of the rows as groups held both groups on every rank.
  * The combine on experts split over "model" (``layers.combine`` /
    ``steps.placed_combine``): the same step with its 8 groups on a
    (1, 4) mesh equals the plain one, and no gather of the step
    replicated a split dimension (``steps.GATHER_REPLICATED``), where the
    combine's gather moved the experts' outputs by all-to-all.
  * The token embedding's gradient (``layers.embedding`` /
    ``steps.placed_embedding``): on (1, 4) and (2, 2) meshes, the table
    over "model" by rows and "data" by features, it equals the plain
    gradient and keeps the table's placement; on a fake (1, 4) mesh no
    storage as large as the whole table is live at the step's peak,
    where autograd's ``embedding_dense_backward`` made the whole (vocab,
    d) gradient on every rank.
"""

import pytest

from repro_torch.launch import meshcheck


@pytest.fixture(scope="module")
def placement():
    return meshcheck.check_placement()


def test_groups_over_two_ranks_equal_the_plain_step(placement):
    """Two routing groups over four batch ranks: every parameter, the loss
    and the grad norm within ``meshcheck.TOL`` of the plain step's."""
    dist = placement["distances"]["groups"]
    assert all(v <= meshcheck.TOL for v in dist.values()), dist


def test_each_rank_computes_one_group(placement):
    """The smoke MoE layer (no shared experts) forward and backward, 2
    groups on a fake (4, 1) mesh: each rank does exactly half the
    unplaced flops, one group's."""
    plain, split = placement["traces"]["groups"]["flops"]
    assert plain == 2 * split, (plain, split)


def test_combine_on_split_experts_equals_plain_and_gathers_nothing(
        placement):
    """The 8 experts over "model" 4: the step within ``TOL`` of the plain
    one, and no gather along a split dimension in either placed step."""
    dist = placement["distances"]["combine"]
    assert all(v <= meshcheck.TOL for v in dist.values()), dist
    assert placement["replicated"] == {"groups": {}, "combine": {}}


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_embedding_gradient_equals_plain(placement, mesh):
    """The embedding's gradient on the mesh (ids at every edge of the
    table's slices, one id twice) against the unplaced op's, within 1e-6
    of its largest entry, in the table's placement."""
    assert placement["distances"][f"embed_{mesh}"]["grad"] <= 1e-6
    assert placement["placements"][mesh] == ["S(1)", "S(0)"]


def test_embedding_backward_holds_no_whole_table(placement):
    """At the embedding step's peak on a fake (1, 4) mesh the largest
    storage is below the whole table's bytes, and none is
    ``embedding_dense_backward``'s."""
    emb = placement["traces"]["embed"]
    op, nbytes = emb["largest"]
    assert nbytes < emb["table_bytes"], emb
    assert "embedding_dense_backward" not in op


def test_placement_part_passes(placement):
    """``meshcheck.placement_ok`` over the whole record, as phase "mesh"
    applies it."""
    assert placement["ok"], placement
