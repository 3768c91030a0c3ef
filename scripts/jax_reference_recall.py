"""The JAX package's recall@10 under scripts/sparse_quality_check.py's
protocol, for each scorer and seed: the reference the port's
``chip_smoke.py`` ``reference_recall`` phase is held to (``JAX_RECALL``).

Protocol: configs/tdm.conf's trainer (E = 16, lr 1e-4, batch 8192, its
negatives, beam 20, top-10), dense Adam, 2000 iterations on the category
tree of data/example_data.csv, then ``evaluate`` on the whole eval split.
``--embed`` and ``--lr`` change the width and the learning rate: ``--embed
64 --lr 3e-3 --models din`` is stage 1 of scripts/quality_push.py's e64x6k
cut to 2000 iterations (``chip_smoke.py``'s ``JAX_RECALL_E64``).  One JSON
line a run, then one with each model's mean recall.

Usage (the CPU; ~40 s a run at E = 16):
    python scripts/jax_reference_recall.py [--iters 2000] [--models din,deepfm] [--seeds 0,1,2]
        [--embed 16] [--lr 1e-4]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dismember_tpu.data.ingest import (  # noqa: E402
    read_csv,
    unique_items_with_category,
    user_interactions,
)
from dismember_tpu.data.tdm_dataset import generate_split_samples  # noqa: E402
from dismember_tpu.index.arraytree import ArrayTree  # noqa: E402
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree  # noqa: E402
from dismember_tpu.train.tdm import TDMTrainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--models", default="din,deepfm")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--embed", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    args = ap.parse_args()
    raw = read_csv(os.path.join(ROOT, "data", "example_data.csv"))
    s = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    sid, codes = category_sorted_codes(*unique_items_with_category(raw))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "tree.bin")
        write_tree(path, sid, codes, stat=s.stat)
        tree = ArrayTree.from_file(path)
    means = {}
    for model in args.models.split(","):
        recalls = []
        for seed in (int(x) for x in args.seeds.split(",")):
            t0 = time.perf_counter()
            tr = TDMTrainer(tree=tree, model_type=model, embed_size=args.embed,
                            learning_rate=args.lr,
                            total_batch_size=8192, total_eval_batch_size=8192,
                            layer_neg_counts=NEG, topk=10, beam_size=20, seed=seed,
                            sparse_embed_update=False)
            tr.train(s.train_seqs, s.train_targets, iterations=args.iters,
                     progress_interval=1000)
            ev = tr.evaluate((s.eval_seqs, s.eval_labels, s.eval_users), s.user_consumed)
            c = max(ev.count, 1)
            recalls.append(ev.recall / c)
            print(json.dumps({"model": model, "seed": seed, "iters": args.iters,
                              "embed": args.embed, "lr": args.lr,
                              "recall": ev.recall / c, "precision": ev.precision / c,
                              "ndcg": ev.ndcg / c, "eval_windows": ev.count,
                              "seconds": time.perf_counter() - t0}), flush=True)
        means[model] = sum(recalls) / len(recalls)
    print(json.dumps({"mean_recall": means}), flush=True)


if __name__ == "__main__":
    main()
