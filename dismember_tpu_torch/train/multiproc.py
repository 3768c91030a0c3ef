"""Multi-process SPMD harness.

Port of ``dismember_tpu/train/multiproc.py`` and of the worker script
beside it.  The JAX package's backend is its distributed runtime; the
port's is ``torch.distributed``: N processes, one device each, the same
program on every rank, collectives over nccl (cards) or gloo (CPU, or
ranks sharing a card).

- :func:`initialize` starts the process group from a ``file://`` or an
  ``env://`` store;
- :func:`spawn` runs a function on N spawned ranks and returns their
  results (the tests and ``chip_smoke.py`` use it), with a join timeout so
  a hang fails the caller and never blocks it;
- :func:`run_tdm_steps` runs sharded dense TDM steps and a sharded classic
  beam, :func:`run_deep_serving` the sharded packed beam on a 2^14-item
  tree and the sharded DR E-step and block serving;
- ``python -m dismember_tpu_torch.train.multiproc --process-id I
  --num-processes N --init-method file:///tmp/store ...`` is one rank of a
  hand-launched run (the part of the JAX package's
  ``scripts/multiproc_worker.py``); rank 0 writes the results to ``--out``.

Every rank builds the index on rank 0 and broadcasts it
(``core.multihost.broadcast_from_host0``), draws the global batches from a
shared seed and feeds its "data" rows, so the results do not depend on the
process layout beyond the "data" axis's summation order.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

NEG_COUNTS = "0,1,2,3,4,5"


def initialize(init_method: str, num_processes: int, process_id: int,
               device: str = "cuda", backend: str | None = None) -> torch.device:
    """Bring up ``torch.distributed`` for this process; returns its device
    (``core.mesh.init_distributed``)."""
    from dismember_tpu_torch.core import mesh as meshlib

    return meshlib.init_distributed(init_method, num_processes, process_id, backend=backend,
                                    device=device)


def _rank_main(rank: int, nprocs: int, store: str, device: str, backend: str | None,
               fn: Callable, args: tuple, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * nprocs)))
    dev = initialize(f"file://{store}", nprocs, rank, device=device, backend=backend)
    try:
        result = fn(dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()  # no rank tears its connections down while another still uses them
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), device: str = "cuda",
          backend: str | None = None, timeout: float = 120.0) -> list[Any]:
    """Run ``fn(device, *args)`` on ``nprocs`` spawned ranks of one group
    (a ``file://`` store in a fresh temporary directory; ``fn`` must be
    importable by name) and return each rank's result.  Raises if a rank
    fails or the ranks do not finish within ``timeout`` seconds (the ranks
    are then killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, store, device, backend, fn, args, tmp))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive:
            raise TimeoutError(f"{len(alive)} of {nprocs} ranks still running after {timeout} s")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} failed (exit codes "
                               f"{[procs[r].exitcode for r in bad]})")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _tree_from_host0(n_items: int, cats_of: Callable, tmp: str):
    """The tree of ``n_items`` items built on rank 0 and broadcast."""
    from dismember_tpu_torch.core import multihost
    from dismember_tpu_torch.index.arraytree import ArrayTree
    from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree

    if multihost.process_index() == 0:
        ids = np.arange(1, n_items + 1)
        sorted_ids, codes = category_sorted_codes(ids, cats_of(ids))
    else:
        sorted_ids = np.zeros(n_items, dtype=np.int64)
        codes = np.zeros(n_items, dtype=np.int64)
    sorted_ids, codes = multihost.broadcast_from_host0([np.asarray(sorted_ids, np.int64),
                                                        np.asarray(codes, np.int64)])
    multihost.assert_same_across_hosts(codes, "leaf codes")
    path = os.path.join(tmp, f"tree{multihost.process_index()}.bin")
    write_tree(path, sorted_ids, codes)
    return ArrayTree.from_file(path)


def tdm_batches(tree, steps: int, global_batch_size: int, n_items: int, seed: int):
    """The global (target codes, sequence codes) batches of
    :func:`run_tdm_steps` and its eval sequences: the JAX harness's numpy
    draws."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        tc = rng.choice(tree.item_codes, global_batch_size).astype(np.int64)
        sc = tree.ids_to_codes(rng.integers(1, n_items + 1, size=(global_batch_size, 10)))
        batches.append((tc, sc.astype(np.int64)))
    evals = tree.ids_to_codes(np.random.default_rng(seed + 2).integers(
        1, n_items + 1, size=(global_batch_size, 10))).astype(np.int64)
    return batches, evals


def run_tdm_steps(steps: int = 4, global_batch_size: int = 16, n_model: int = 2,
                  embed_size: int = 16, seed: int = 0, device: str = "cuda",
                  inputs: dict | None = None) -> dict[str, Any]:
    """``steps`` sharded dense TDM steps (DIN, ``NEG_COUNTS``) over every
    rank on a (world / n_model, n_model) mesh, then a sharded classic beam
    of 4 over the trained table.  ``inputs`` may hold the initial params
    (``"param:<name>"``, padded rows) and each step's global draws
    (``"codes_i"``, ``"labels_i"``, ``"weights_i"``), so another package's
    draws can be fed; without them the trainer draws its own.  Returns
    {"losses", "params" (gathered), "beam_ids", "beam_scores"} on every
    rank."""
    import torch.distributed as dist

    from dismember_tpu_torch.core import mesh as meshlib, multihost
    from dismember_tpu_torch.train import spmd
    from dismember_tpu_torch.train.sampler import TreeSampler
    from dismember_tpu_torch.train.tdm import TDMTrainer, _stream_seed

    mesh = meshlib.make_mesh(dist.get_world_size() // n_model, n_model, device=device)
    n_items = 32
    with tempfile.TemporaryDirectory() as tmp:
        tree = _tree_from_host0(n_items, lambda ids: np.zeros(len(ids), np.int64), tmp)
    unit = TreeSampler.build(tree, NEG_COUNTS, start_level=1, device="cpu").unit
    tr = TDMTrainer(tree=tree, layer_neg_counts=NEG_COUNTS, embed_size=embed_size,
                    learning_rate=1e-3, total_batch_size=global_batch_size * unit,
                    sparse_embed_update=False, seed=seed, mesh=mesh, device=device)
    inputs = inputs or {}
    params = {k[len("param:"):]: v for k, v in inputs.items() if k.startswith("param:")}
    if params:
        tr.load_numpy(_unflatten(params))
    batches, evals = tdm_batches(tree, steps, global_batch_size, n_items, seed)
    losses = []
    for i, (tc, sc) in enumerate(batches):
        if f"codes_{i}" in inputs:
            loss = tr.step_from_samples(*multihost.device_batch(
                mesh, sc, inputs[f"codes_{i}"].astype(np.int64), inputs[f"labels_{i}"],
                inputs[f"weights_{i}"]))
        else:
            tr._gen.manual_seed(_stream_seed(seed, 1, i))
            loss = tr._train_step(tr._codes(tc), tr._codes(sc))
        losses.append(float(loss))
    with tr.whole_table():
        host_params = multihost.gather_to_host(tr.model.param_tree())
        beam_fn = spmd.make_sharded_beam_fn(tr.model, tree, 4, mesh)
    ids, scores = beam_fn(multihost.device_batch(mesh, evals))
    beam = multihost.gather_to_host({"ids": ids, "scores": scores}, mesh, meshlib.DATA_AXIS)
    return {"losses": losses, "params": host_params, "beam_ids": beam["ids"],
            "beam_scores": beam["scores"]}


def _unflatten(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def dr_inputs(seed: int = 0, n_dr: int = 4096, seq_len: int = 6, n_rows: int = 64,
              batch: int = 16):
    """(DRData, eval sequences) of :func:`run_deep_serving`'s DR leg, the
    same on every rank."""
    from dismember_tpu_torch.data.dr_dataset import DRData

    rng2 = np.random.default_rng(seed + 2)
    data = DRData(
        item_to_id={i: i for i in range(n_dr)}, id_to_item={i: i for i in range(n_dr)},
        num_items=n_dr,
        train_seqs=rng2.integers(0, n_dr, size=(n_rows, seq_len)).astype(np.int64),
        train_targets=rng2.integers(0, n_dr, size=n_rows).astype(np.int64),
        eval_seqs=np.zeros((0, seq_len), np.int64), eval_labels=np.zeros((0, 1), np.int64),
        eval_users=np.zeros(0, np.int64), user_consumed={})
    evals = rng2.integers(0, n_dr, size=(batch, seq_len)).astype(np.int64)
    return data, evals


DR_KW = dict(num_layers=2, num_nodes=16, num_paths_per_item=2, embed_size=8,
             learning_rate=3e-3, num_sampled=2, beam_size=4, seq_len=6)


def deep_tree_cats(ids: np.ndarray) -> np.ndarray:
    """The deep catalog's categories: ``id % 97``."""
    return ids % 97


def run_deep_serving(n_items: int = 1 << 14, n_model: int = 2, global_batch_size: int = 16,
                     embed_size: int = 16, seed: int = 0, device: str = "cuda",
                     inputs: dict | None = None) -> dict[str, Any]:
    """The deep-serving and sharded-DR leg over every rank: the packed
    beam of 8 with its pair table row-sharded on "model" (K3 a level) on a
    2^14-item tree, then DR's sharded pmv E-step (one layer and one rerank
    step, three K2 commits) and the sharded block serving.  ``inputs`` may
    hold the DIN params (``"din:<name>"``), the DR params (``"layer:..."``,
    ``"rerank:..."``) and each data shard's negatives (``"negs_<d>"``).
    Returns numpy results gathered to every rank."""
    import torch.distributed as dist

    from dismember_tpu_torch.core import mesh as meshlib, multihost
    from dismember_tpu_torch.models.din import DIN
    from dismember_tpu_torch.retrieval.packed_beam import make_packed_tree
    from dismember_tpu_torch.train import spmd, spmd_dr
    from dismember_tpu_torch.train.dr import DRTrainer

    mesh = meshlib.make_mesh(dist.get_world_size() // n_model, n_model, device=device)
    dev = meshlib.mesh_device(mesh)
    inputs = inputs or {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = _tree_from_host0(n_items, deep_tree_cats, tmp)
    num_index = (1 << (tree.max_level + 1)) - 1
    model = DIN(num_index, embed_size, device=dev, generator=torch.Generator().manual_seed(seed))
    din = {k[len("din:"):]: v for k, v in inputs.items() if k.startswith("din:")}
    if din:
        model.load_numpy(_unflatten(din))
    packed = make_packed_tree(tree, model.embedding.detach(), beam=8)
    beam_fn = spmd.make_sharded_packed_beam_fn(packed, mesh, DIN.precompute_seq)
    del packed
    seq_codes = tree.ids_to_codes(np.random.default_rng(seed + 1).integers(
        1, n_items + 1, size=(global_batch_size, 10))).astype(np.int64)
    ids, scores = beam_fn(model, multihost.device_batch(mesh, seq_codes))
    packed_out = multihost.gather_to_host({"ids": ids, "scores": scores}, mesh,
                                          meshlib.DATA_AXIS)

    data, evals = dr_inputs(seed, batch=global_batch_size)
    multihost.assert_same_across_hosts(data.train_targets, "dr targets")
    tr = DRTrainer(data, seed=seed, mesh=mesh, device=device, **DR_KW)
    layer = {k[len("layer:"):]: v for k, v in inputs.items() if k.startswith("layer:")}
    if layer:
        rerank = {k[len("rerank:"):]: v for k, v in inputs.items() if k.startswith("rerank:")}
        tr.load_params(_unflatten(layer), _unflatten(rerank))
    seqs, paths, labels = multihost.device_batch(
        mesh, data.train_seqs, tr.path_index.item_paths[data.train_targets], data.train_targets)
    d = meshlib.axis_index(mesh, meshlib.DATA_AXIS)
    negs = (torch.as_tensor(inputs[f"negs_{d}"], device=dev) if f"negs_{d}" in inputs
            else tr.sample_negatives(labels))
    layer_losses = tr._layer_step(seqs, paths)
    rerank_loss = tr._rerank_step(seqs, labels, negs)
    es, consumed = multihost.device_batch(mesh, evals,
                                          np.full((global_batch_size, 1), -1, np.int64))
    with tr.whole_table():
        serve = spmd_dr.make_sharded_dr_serving_fn(tr, mesh, topk=5)
        dr_ids, dr_scores = serve(tr.layer_params, tr.rerank_params, es, consumed)
        dr_params = multihost.gather_to_host({"layer": tr.layer_params,
                                              "rerank": tr.rerank_params})
    dr_out = multihost.gather_to_host({"ids": dr_ids, "scores": dr_scores}, mesh,
                                      meshlib.DATA_AXIS)
    return {
        "packed_ids": packed_out["ids"], "packed_scores": packed_out["scores"],
        "dr_layer_losses": layer_losses.cpu().numpy(), "dr_rerank_loss": float(rerank_loss),
        "dr_ids": dr_out["ids"], "dr_scores": dr_out["scores"], "dr_params": dr_params,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--init-method", required=True,
                    help="the group's store: file:///path or env://")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--n-model", type=int, default=2)
    ap.add_argument("--mode", choices=["tdm", "deep"], default="tdm")
    ap.add_argument("--inputs", default="", help="an .npz of inputs (see run_tdm_steps)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from dismember_tpu_torch.core.checkpoint import flatten

    initialize(args.init_method, args.num_processes, args.process_id, device=args.device,
               backend=args.backend)
    assert dist.get_world_size() == args.num_processes
    inputs = dict(np.load(args.inputs)) if args.inputs else None
    if args.mode == "deep":
        result = run_deep_serving(n_model=args.n_model, global_batch_size=args.global_batch,
                                  device=args.device, inputs=inputs)
        msg = f"rerank_loss={result['dr_rerank_loss']:.4f}"
    else:
        result = run_tdm_steps(steps=args.steps, global_batch_size=args.global_batch,
                               n_model=args.n_model, device=args.device, inputs=inputs)
        msg = f"losses={result['losses']}"
    if args.out and args.process_id == 0:
        flat = {}
        for k, v in result.items():
            if isinstance(v, dict):
                flat.update({f"{k}:{n}": np.asarray(x) for n, x in flatten(v).items()})
            else:
                flat[k] = np.asarray(v)
        np.savez(args.out, **flat)
    print(f"multiproc worker {args.process_id}/{args.num_processes}: {msg}", flush=True)
    dist.barrier()  # no rank tears its connections down while another still uses them
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
