"""The plain reference against the port's CPU plain path at a tiny tree:
the same tree, the same DIN logits (f32, and K3's bf16 operands), the same
served lists, and the same train step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import inputs
from drivers import common
from reference import beam as ref_beam
from reference import din as ref_din
from reference import precision
from reference import train as ref_train
from reference import tree as ref_tree

CFG = {"items": 5000, "categories": 37, "embed_size": 16,
       "assumed": {"weights": {"embedding_std": 1.0, "weight_std": 0.5}}}


@pytest.fixture(scope="module")
def trees():
    return ref_tree.category_tree(*inputs.catalog(CFG)), common.program_tree(CFG)


@pytest.fixture(scope="module")
def weights(trees):
    return common.weights(CFG, 7, (1 << (trees[0].max_level + 1)) - 1, torch.device("cpu"))


def test_tree_is_the_programs(trees):
    ref, prog = trees
    assert ref.max_level == prog.max_level
    np.testing.assert_array_equal(ref.item_ids, prog.item_ids)
    np.testing.assert_array_equal(ref.leaf_codes, prog.item_codes)
    np.testing.assert_array_equal(ref.exists, prog.node_exists)


def test_din_logits_are_the_programs(trees, weights):
    from dismember_tpu_torch.ops.din_kernel import din_score_plain
    from dismember_tpu_torch.ops.packed_level_kernel import packed_level_plain
    from dismember_tpu_torch.retrieval.packed_beam import build_pair_table

    ref, _ = trees
    g = torch.Generator().manual_seed(3)
    n = (1 << (ref.max_level + 1)) - 1
    seq = torch.randint(0, n, (64, 10), generator=g)
    seq[:, :3] = torch.where(torch.rand(64, 3, generator=g) < 0.3, -1, seq[:, :3])
    cand = torch.randint(0, n, (64, 40), generator=g)
    w = common.tower(weights)
    tw = (w["att_w"], w["w1"], w["b1"], w["w2"], w["b2"])
    item_e, seq_e = ref_din.gather(weights["table"], cand), ref_din.gather(weights["table"], seq)
    pad = (seq == -1).float()
    got = din_score_plain(item_e, seq_e, pad, *tw)
    want = ref_din.logits(item_e, seq_e, seq == -1, w)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
    # K3's plain version: the same logits with bf16 operands, over pair rows
    parents = torch.randint(0, (n - 1) // 2, (64, 20), generator=g)
    table = build_pair_table(weights["table"], ref.exists, ref.leaf_item.astype(np.int32), n)
    scores, _ = packed_level_plain(table[parents], torch.ones(64, 20), seq_e, pad, *tw, 16)
    kids = torch.cat([2 * parents + 1, 2 * parents + 2], 1)
    want = ref_din.logits(ref_din.gather(weights["table"], kids), seq_e, seq == -1, w,
                          precision.bf16)
    ok = torch.as_tensor(ref.exists)[kids]
    torch.testing.assert_close(scores[ok], want[ok], rtol=1e-5, atol=1e-5)


def test_served_lists_are_the_programs(trees, weights):
    """The program's classic f32 beam search serves the reference's lists."""
    from dismember_tpu_torch.models.din import DIN
    from dismember_tpu_torch.serving import TDMServing
    from dismember_tpu_torch.train.tdm import serving_fns

    ref, prog = trees
    pre, app = serving_fns("din")
    model = common.din_module({k: v.clone() for k, v in weights.items()}, torch.device("cpu"))
    serv = TDMServing(model, DIN.forward, prog, precompute=pre, apply=app, packed=False,
                      model_type="din")
    g = inputs.generator(5, inputs.TRAFFIC, torch.device("cpu"))
    pop = inputs.Popularity(CFG["items"], {"kind": "zipf", "exponent": 1.0}, torch.device("cpu"))
    seqs = inputs.windows(pop, g, 64, 10, 2, 0.3).numpy()
    cons = [s[s > 0] for s in seqs]
    served = serv.recommend_batch(seqs, consumed=cons)
    sc = torch.as_tensor(ref.codes(seqs))
    scorer = ref_beam.Scorer(weights["table"], common.tower(weights), sc)
    exists = torch.as_tensor(ref.exists)
    codes, _ = ref_beam.beam_search(scorer, exists, ref.max_level, 20, 10, sc)
    got = torch.as_tensor(ref_beam.codes_of(ref, served, 10))
    numbers = ref_beam.judge(scorer, exists, got, sc, codes, _)
    assert numbers["bad_items"] == 0
    assert numbers["order_gap"] < 1e-5
    assert numbers["list_miss"] < 0.02  # near ties of f32 sums in another order


def test_train_step_is_the_programs(trees, weights):
    """The follower's step equals the program's dense-route step on the same
    draws (a dense step is lazy Adam on a step's touched rows' first step)."""
    from dismember_tpu_torch.train.tdm import TDMTrainer

    _, prog = trees
    counts = ",".join(str(min(i, 2**i - 1)) for i in range(prog.max_level + 1))
    t = TDMTrainer(tree=prog, layer_neg_counts=counts, total_batch_size=512, seed=3,
                   sparse_embed_update=True, sparse_format="mv", device="cpu")
    common.load_into(t.model, weights)
    leaves = torch.as_tensor(prog.item_codes[:t.num_targets_per_batch], dtype=torch.long)
    seq = torch.as_tensor(prog.item_codes[100:100 + 10 * len(leaves)],
                          dtype=torch.long).view(len(leaves), 10)
    codes, labels, wts = t.sample(leaves)
    f = ref_train.Follower(weights["table"], common.tower(weights),
                           torch.cat([codes.reshape(-1), seq.reshape(-1)]), t.learning_rate)
    for _ in range(2):
        loss = t.step_from_samples(seq, codes, labels, wts)
        want = f.step(seq, codes, labels, wts)
        assert float(loss) == pytest.approx(want, rel=1e-6)
    table = t.model.embedding.detach()[f.codes]
    torch.testing.assert_close(table, f.rows, rtol=1e-5, atol=1e-6)
