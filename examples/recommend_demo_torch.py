"""Serving API demo of the PyTorch port: load persisted TDM artifacts and
recommend.

The port's counterpart of ``examples/recommend_demo.py`` (itself the
reference's Java API demo, examples/src/main/java/com/mass/retrieval/tdm/
JavaRecommend.java): load a saved model + tree with
``dismember_tpu_torch.serving.TDMServing.load``, run a recommendation, and
measure single-query latency and batched throughput.  Checkpoints and trees
of either package load.

Usage: python examples/recommend_demo_torch.py <model_ckpt> <tree.bin> [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dismember_tpu_torch.serving import TDMServing  # noqa: E402


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def main(model_path: str, tree_path: str, device: str = "cuda") -> None:
    serving = TDMServing.load(model_path, tree_path, device=device, topk=10, candidate_num=20)
    sequence = np.asarray(serving.tree.item_ids[:10])

    rec = serving.recommend(sequence, topk=10)
    print(f"Recommendation result: {rec.tolist()}")

    n = 100
    start = time.perf_counter()
    for _ in range(n):
        serving.recommend(sequence, topk=10)
    avg_ms = (time.perf_counter() - start) / n * 1e3
    print(f"Average recommend time: {avg_ms:.4f}ms")

    batch = np.tile(sequence, (4096, 1))
    serving.recommend_batch(batch)  # warm up: builds the pair table
    _sync(device)
    start = time.perf_counter()
    serving.recommend_batch(batch)
    _sync(device)
    qps = len(batch) / (time.perf_counter() - start)
    print(f"Batched throughput: {qps:,.0f} queries/s on {device}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model_path")
    parser.add_argument("tree_path")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.model_path, args.tree_path, args.device)
