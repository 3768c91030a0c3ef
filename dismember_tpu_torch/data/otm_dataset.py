"""OTM dataset: leaf mapping init + multi-label windowing.

Copy of ``dismember_tpu/data/otm_dataset.py`` (numpy only).  Parity with otm/.../dataset/LocalDataSet.scala:15-232:
- items are mapped to *leaf codes* of an implicit complete binary tree of
  ``leaf_level = ceil(log2(num_items))``; leaves are sampled among the
  2^leaf_level bottom positions (``sampleRandomLeaves``), item order either
  shuffled ("random") or category-sorted ("category");
- sequences/labels/consumed are stored in mapped-code space with -1 padding
  (note: OTM pads with paddingIdx, not item id 0);
- multi-label windows: each train sample has ``label_num`` targets; eval =
  one sample per user with all future items (not consumed-filtered — unlike
  TDM, see generateSamples:69-104).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.data.ingest import InitSamples, read_csv


def upper_log2(n: int) -> int:
    return int(math.ceil(math.log2(n)))


def lower_log2(n: int) -> int:
    return int(math.floor(math.log2(n)))


@dataclasses.dataclass
class OTMData:
    item_to_code: dict[int, int]  # raw item id -> leaf code
    code_to_item: dict[int, int]
    leaf_level: int
    num_items: int
    all_nodes: np.ndarray  # bool bitmap over [0, 2^(leaf_level+1)-1)
    train_seqs: np.ndarray  # [N, L] codes, -1 padded
    train_labels: np.ndarray  # [N, label_num] codes, -1 padded
    train_users: np.ndarray
    eval_seqs: np.ndarray  # [M, L]
    eval_labels: np.ndarray  # [M, max_labels] codes, -1 padded
    eval_users: np.ndarray
    user_consumed: dict[int, np.ndarray]  # mapped codes
    # configured labels-per-sample; train_labels may be wider in
    # one_user_sample mode (ragged full-future lists, -1 padded)
    label_num: int = 0

    @property
    def num_tree_nodes(self) -> int:
        return (1 << (self.leaf_level + 1)) - 1


def initialize_mapping(
    samples: InitSamples, leaf_init_mode: str, rng: np.random.Generator
) -> tuple[dict[int, int], dict[int, int], int]:
    """item -> leaf-code mapping (initializeMapping/sampleRandomLeaves)."""
    _, first_idx = np.unique(samples.item, return_index=True)
    first_idx = np.sort(first_idx)
    items = samples.item[first_idx]
    cats = samples.category[first_idx]
    if leaf_init_mode == "random":
        order = rng.permutation(len(items))
        ordered = items[order]
    elif leaf_init_mode == "category":
        order = np.lexsort((items, cats))
        ordered = items[order]
    else:
        raise ValueError(f"unknown leaf_init_mode: {leaf_init_mode}")
    leaf_level = upper_log2(len(items))
    leaf_start = (1 << leaf_level) - 1
    leaf_end = 2 * leaf_start + 1
    sampled = np.sort(
        rng.choice(np.arange(leaf_start, leaf_end), size=len(items), replace=False)
    )
    item_to_code = {int(i): int(c) for i, c in zip(ordered, sampled)}
    code_to_item = {int(c): int(i) for i, c in zip(ordered, sampled)}
    return item_to_code, code_to_item, leaf_level


def all_nodes_bitmap(codes: np.ndarray, leaf_level: int) -> np.ndarray:
    """Bitmap of every node on a leaf→root path (getAllNodes parity)."""
    total = (1 << (leaf_level + 1)) - 1
    out = np.zeros(total, dtype=bool)
    cur = codes.astype(np.int64).copy()
    for _ in range(leaf_level + 1):
        out[cur[cur >= 0]] = True
        cur = (cur - 1) >> 1
    return out


def build_otm_data(
    data_path: str,
    seq_len: int,
    min_seq_len: int,
    split_ratio: float,
    leaf_init_mode: str = "random",
    label_num: int = 5,
    seed: int = 42,
    mapping: tuple[dict[int, int], dict[int, int]] | None = None,
    data_mode: str = "default",
) -> OTMData:
    raw = read_csv(data_path)
    rng = np.random.default_rng(seed)
    if mapping is None:
        item_to_code, code_to_item, leaf_level = initialize_mapping(
            raw, leaf_init_mode, rng
        )
    else:
        item_to_code, code_to_item = mapping
        leaf_level = upper_log2(len(item_to_code))

    # group per user, time-sorted distinct, mapped to codes
    order = np.argsort(raw.timestamp, kind="stable")
    users_t = raw.user[order]
    items_t = raw.item[order]
    uorder = np.argsort(users_t, kind="stable")
    users_s = users_t[uorder]
    items_s = items_t[uorder]
    boundaries = np.flatnonzero(np.diff(users_s)) + 1
    groups = np.split(items_s, boundaries)
    group_users = (
        np.concatenate([[users_s[0]], users_s[boundaries]]) if len(users_s) else []
    )

    train_seqs: list[np.ndarray] = []
    train_labels: list[list[int]] = []
    train_users: list[int] = []
    eval_seqs: list[np.ndarray] = []
    eval_labels: list[np.ndarray] = []
    eval_users: list[int] = []
    user_consumed: dict[int, np.ndarray] = {}

    pad = np.full(seq_len - min_seq_len, PADDING_IDX, dtype=np.int64)

    if data_mode == "one_user_sample":
        # OTM's alternate mode (LocalDataSet.generateOneSamplePerUser:48-67):
        # one sample per user — first seq_len items are the sequence, ALL
        # remaining items are labels (variable length, kept in full like the
        # reference's List[Int]); the sample set is shuffled and split by
        # ratio.  Train labels are stored -1-padded to the global max; the
        # trainer re-pads per batch.
        all_samples: list[tuple[np.ndarray, np.ndarray, int]] = []
        for items_u, user in zip(groups, group_users):
            _, fi = np.unique(items_u, return_index=True)
            distinct = items_u[np.sort(fi)]
            codes = np.asarray(
                [item_to_code[int(i)] for i in distinct], dtype=np.int64
            )
            if len(codes) > seq_len:
                seq, labels = codes[:seq_len], codes[seq_len:]
                all_samples.append((seq, labels, int(user)))
                user_consumed[int(user)] = seq
        order = rng.permutation(len(all_samples))
        split_point = int(len(all_samples) * split_ratio)
        for k, oi in enumerate(order):
            seq, labels, user = all_samples[oi]
            if k < split_point:
                train_seqs.append(seq)
                train_labels.append(labels.tolist())
                train_users.append(user)
            else:
                eval_seqs.append(seq)
                eval_labels.append(labels)
                eval_users.append(user)
        groups = []  # default loop below skipped

    for items_u, user in zip(groups, group_users):
        _, fi = np.unique(items_u, return_index=True)
        distinct = items_u[np.sort(fi)]
        codes = np.asarray([item_to_code[int(i)] for i in distinct], dtype=np.int64)
        n = len(codes)
        user = int(user)
        if n <= min_seq_len:
            continue
        if n <= min_seq_len + label_num:
            full = np.concatenate([pad, codes[:min_seq_len]])
            train_seqs.append(full[:seq_len])
            train_labels.append(codes[min_seq_len:].tolist())
            train_users.append(user)
            user_consumed[user] = codes
            continue
        full = np.concatenate([pad, codes])
        split_point = math.ceil((n - min_seq_len) * split_ratio)
        head = full[: split_point + seq_len]
        win = seq_len + label_num
        if len(head) >= win:
            for i in range(len(head) - win + 1):
                w = head[i : i + win]
                train_seqs.append(w[:seq_len])
                train_labels.append(w[seq_len:].tolist())
                train_users.append(user)
        else:
            train_seqs.append(head[:seq_len])
            train_labels.append(head[seq_len:].tolist())
            train_users.append(user)
        user_consumed[user] = codes[: split_point + min_seq_len]
        eval_seq = full[split_point : split_point + seq_len]
        labels = full[split_point + seq_len :]
        eval_seqs.append(eval_seq)
        eval_labels.append(labels)
        eval_users.append(user)

    tl_width = max(label_num, max((len(l) for l in train_labels), default=0))
    tl = np.full((len(train_labels), tl_width), -1, dtype=np.int64)
    for i, l in enumerate(train_labels):
        tl[i, : len(l)] = l
    max_el = max((len(l) for l in eval_labels), default=1)
    el = np.full((len(eval_labels), max_el), -1, dtype=np.int64)
    for i, l in enumerate(eval_labels):
        el[i, : len(l)] = l

    codes_arr = np.asarray(sorted(code_to_item), dtype=np.int64)
    return OTMData(
        item_to_code=item_to_code,
        code_to_item=code_to_item,
        leaf_level=leaf_level,
        num_items=len(item_to_code),
        all_nodes=all_nodes_bitmap(codes_arr, leaf_level),
        train_seqs=(
            np.stack(train_seqs)
            if train_seqs
            else np.zeros((0, seq_len), dtype=np.int64)
        ),
        train_labels=tl,
        train_users=np.asarray(train_users, dtype=np.int64),
        eval_seqs=(
            np.stack(eval_seqs) if eval_seqs else np.zeros((0, seq_len), dtype=np.int64)
        ),
        eval_labels=el,
        eval_users=np.asarray(eval_users, dtype=np.int64),
        user_consumed=user_consumed,
        label_num=label_num,
    )


def save_mapping(path: str, item_to_code: dict[int, int]) -> None:
    """``item code`` text lines (tdm Serialization.saveMapping parity)."""
    with open_file(path, "w", encoding="utf-8") as f:
        for item, code in item_to_code.items():
            f.write(f"{item} {code}\n")


def load_mapping(path: str) -> tuple[dict[int, int], dict[int, int]]:
    item_to_code: dict[int, int] = {}
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                item_to_code[int(parts[0])] = int(parts[-1])
    return item_to_code, {v: k for k, v in item_to_code.items()}
