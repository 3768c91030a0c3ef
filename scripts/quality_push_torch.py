"""The wide-scorer quality recipe of ``scripts/quality_push.py`` on the
PyTorch port (``dismember_tpu_torch`` only).

Each variant runs three stages; each trains a fresh DIN scorer on the
current tree and evaluates it on the whole eval split (the reference's
alternation protocol, doc/TDM.md and doc/JTM.md):
  1. the category tree;
  2. the stage-1 scorer's leaf embeddings re-clustered
     (``export_embeddings`` -> ``cluster_tree_from_embeddings``, 10 k-means
     iterations);
  3. JTM tree learning (``TreeLearner(gap=2).optimize()``) with the stage-2
     scorer, written as a tree (``write_projection_tree``).
It prints one JSON line a stage: recall, precision and nDCG@10 per eval
window, and the stage's seconds.  Trees and embeddings go to ``--out``
(``build/quality_push_torch/`` by default).

Usage:
    python scripts/quality_push_torch.py [variant[:seed] ...] [--iters N]
        [--csv data/example_data.csv] [--device cuda] [--out DIR]

Variants are ``VARIANTS``' names (default ``e64x8k e96x6k``, as
``scripts/quality_push.py``), each at seed 1 unless ``:seed`` is given;
``--iters`` replaces each stage's iterations.  The widths (64, 96, 128) run
on the card through K1 and K3; ``--device cpu`` runs the plain versions,
for a few iterations at most.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from dismember_tpu_torch.data.ingest import (  # noqa: E402
    read_csv,
    unique_items_with_category,
    user_interactions,
)
from dismember_tpu_torch.data.tdm_dataset import generate_split_samples  # noqa: E402
from dismember_tpu_torch.index.arraytree import ArrayTree  # noqa: E402
from dismember_tpu_torch.index.cluster import cluster_tree_from_embeddings  # noqa: E402
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree  # noqa: E402
from dismember_tpu_torch.train.jtm import TreeLearner, write_projection_tree  # noqa: E402
from dismember_tpu_torch.train.tdm import TDMTrainer  # noqa: E402

CSV = os.path.join(ROOT, "data", "example_data.csv")
OUT = os.path.join(ROOT, "build", "quality_push_torch")
NEG = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"

# scripts/quality_push.py's variants: width, iterations a stage, learning rate
VARIANTS = {
    "e64x6k": dict(embed=64, iters=6000, lr=3e-3),
    "e64x8k": dict(embed=64, iters=8000, lr=3e-3),
    "e96x6k": dict(embed=96, iters=6000, lr=3e-3),
    "e64x6k-lr2": dict(embed=64, iters=6000, lr=2e-3),
    "e128x6k": dict(embed=128, iters=6000, lr=3e-3),
}


@dataclasses.dataclass
class Data:
    """The CSV's windows (10 positions, 2 eval labels, 80% of users train)
    and its category-sorted items."""

    samples: object
    item_ids: np.ndarray
    codes: np.ndarray

    @property
    def eval(self) -> tuple:
        s = self.samples
        return s.eval_seqs, s.eval_labels, s.eval_users


def load_data(csv: str = CSV) -> Data:
    raw = read_csv(csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, codes = category_sorted_codes(*unique_items_with_category(raw))
    return Data(samples, ids, codes)


def train_eval(tree_path: str, cfg: dict, seed: int, data: Data, device: str,
               iters: int) -> tuple[TDMTrainer, dict]:
    """A fresh scorer trained ``iters`` steps on the tree, and its metrics
    on the whole eval split."""
    s = data.samples
    tr = TDMTrainer(tree=ArrayTree.from_file(tree_path), model_type="din",
                    embed_size=cfg["embed"], learning_rate=cfg["lr"], total_batch_size=8192,
                    layer_neg_counts=NEG, topk=10, beam_size=20, seed=seed, device=device)
    tr.train(s.train_seqs, s.train_targets, iterations=iters, progress_interval=iters)
    e = tr.evaluate(data.eval, s.user_consumed)
    c = max(e.count, 1)
    return tr, {"recall": e.recall / c, "precision": e.precision / c, "ndcg": e.ndcg / c}


def run_variant(name: str, cfg: dict, data: Data, out: str, device: str = "cuda",
                seed: int = 1, iters: int | None = None, report=None) -> TDMTrainer:
    """The three stages of one variant; ``report`` gets each stage's line
    (printed as JSON by default).  Returns the last stage's trainer."""
    report = report or (lambda line: print(json.dumps(line), flush=True))
    iters = iters or cfg["iters"]
    os.makedirs(out, exist_ok=True)
    paths = {s: os.path.join(out, f"{name}_t{i}.bin")
             for i, s in enumerate(("category", "cluster", "jtm"), 1)}
    write_tree(paths["category"], data.item_ids, data.codes, stat=data.samples.stat)

    def stage(label: str, t0: float, tree_path: str):
        tr, m = train_eval(tree_path, cfg, seed, data, device, iters)
        report({"run": f"{name}-{label}", "embed": cfg["embed"], "lr": cfg["lr"],
                "iters": iters, "seed": seed, "device": str(tr.device), **m,
                "seconds": time.perf_counter() - t0})
        return tr

    t0 = time.perf_counter()
    tr = stage("stage1-category", t0, paths["category"])
    t0 = time.perf_counter()
    emb_csv = os.path.join(out, f"{name}_emb1.csv")
    tr.export_embeddings(emb_csv)
    cluster_tree_from_embeddings(emb_csv, paths["cluster"], cluster_iter=10, device=device)
    tr = stage("stage2-cluster", t0, paths["cluster"])
    t0 = time.perf_counter()
    s = data.samples
    proj = TreeLearner(tree=tr.tree, model=tr.model, train_seqs=s.train_seqs,
                       train_targets=s.train_targets, gap=2, device=device).optimize()
    write_projection_tree(tr.tree, proj, paths["jtm"])
    return stage("stage3-jtm", t0, paths["jtm"])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=["e64x8k", "e96x6k"])
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations a stage (default: the variant's)")
    ap.add_argument("--csv", default=CSV)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    data = load_data(args.csv)
    for v in args.variants:
        base, _, seed = v.partition(":")
        run_variant(v.replace(":", "-s"), VARIANTS[base], data, args.out, args.device,
                    seed=int(seed or 1), iters=args.iters)


if __name__ == "__main__":
    main()
