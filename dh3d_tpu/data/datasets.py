"""Training/eval data samplers, mirroring `core/datasets.py` without
tensorpack: plain Python iterators + numpy RNG, yielding ready-to-jit
batch dicts for the trainer.

  LocalTrainSelfPair    `core/datasets.py:103-160`
  GlobalTrainTriplet    `core/datasets.py:163-233`
  LocalTestDataset      `core/datasets.py:60-100`
  GlobalTestDataset     `core/datasets.py:236-274`
"""

from __future__ import annotations

import glob
import os
import random
from typing import Iterator, List, Optional

import numpy as np

from dh3d_tpu.data.augment import get_augmentations_from_list
from dh3d_tpu.data.io import (
    FarthestSampler,
    get_fixednum_pcd,
    get_sets_dict,
    load_single_pcfile,
)


class LocalTrainSelfPair:
    """Self-pair sampler for local training: load one cloud, two independent
    augmentations, random 1-D z-rotation applied to copy 2 (its matrix is
    returned as the correspondence warp), FPS over a random half-subset for
    anchor nodes, KD-tree 1-NN in copy 2 for positives
    (`core/datasets.py:126-151`).
    """

    def __init__(self, basedir, train_file, numpts=8192, sample_nodes=512,
                 rot_maxv=np.pi, aug=("Jitter",), shuffle=True, seed=0):
        self.basedir = basedir
        self.numpts = numpts
        self.sample_nodes = sample_nodes
        self.rot_maxv = rot_maxv
        self.augmentation = get_augmentations_from_list(list(aug))
        self.dict = get_sets_dict(train_file)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.dict)

    def _process(self, cloud):
        cloud, _ = get_fixednum_pcd(
            cloud, self.numpts, randsample=True, need_downsample=False,
            sortby_dis=False, rng=self.rng,
        )
        for a in self.augmentation:
            cloud = a.apply(cloud, self.rng)
        return cloud.astype(np.float32)

    def load_pair(self, ind):
        from dh3d_tpu import native

        pcfile = os.path.join(self.basedir, self.dict[ind]["query"] + ".bin")
        cloud = load_single_pcfile(pcfile)
        pc1 = self._process(cloud[:, :3])
        pc2 = self._process(cloud[:, :3])

        angle = self.rng.uniform(-self.rot_maxv, self.rot_maxv)
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
        pc2_t = np.dot(pc2, rot).astype(np.float32)

        subset = self.rng.choice(pc1.shape[0], pc1.shape[0] // 2,
                                 replace=False)
        # 1-NN correspondences are queried in the UNROTATED pc2
        # (`core/datasets.py:148`: `tree = KDTree(pc2)`); indices are shared
        # between pc2 and pc2_t, and the losses warp anchors by R before
        # comparing, so querying the rotated copy would silently break
        # positives for large rotations.
        if native.available():
            # native hot loop: C++ FPS + grid 1-NN (vs python FPS + KD-tree)
            node_sub = native.fps(
                pc1[subset], self.sample_nodes,
                seed_idx=self.rng.randint(len(subset)),
            )
            anc_inds = subset[node_sub]
            pos_inds = native.nn1(pc1[anc_inds], pc2)
        else:
            from scipy.spatial import cKDTree

            node_sub = FarthestSampler().sample(
                pc1[subset], self.sample_nodes, self.rng
            )
            anc_inds = subset[node_sub]
            _, pos_inds = cKDTree(pc2).query(pc1[anc_inds], k=1)
        return pc1, pc2_t, rot, anc_inds.astype(np.int32), \
            np.asarray(pos_inds).flatten().astype(np.int32)

    def __iter__(self):
        order = list(range(len(self)))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in order:
            yield self.load_pair(i)

    def batches(self, batch_size) -> Iterator[dict]:
        """Collate into the trainer batch dict:
        points [2B, N, 3] (anchors | positives), sample_inds [2B, M],
        R [B, 3, 3] — the model's tuple-concat layout
        (`core/model.py:139-146,159-161`).
        """
        buf = []
        for item in self:
            buf.append(item)
            if len(buf) == batch_size:
                yield collate_local(buf)
                buf = []

    def load_raw(self, ind):
        """Host side of on-device pair generation: load + fixed-size
        normalize + augment both copies, nothing else — rotation, FPS
        anchors and 1-NN correspondences run inside the jitted step
        (`dh3d_tpu/data/pairgen.py`)."""
        pcfile = os.path.join(self.basedir, self.dict[ind]["query"] + ".bin")
        cloud = load_single_pcfile(pcfile)
        pc1 = self._process(cloud[:, :3])
        pc2 = self._process(cloud[:, :3])
        return pc1, pc2

    def raw_batches(self, batch_size) -> Iterator[dict]:
        """Batches of {pc1 [B,N,3], pc2 [B,N,3]} (both unrotated) for the
        device-pairgen trainer path."""
        order = list(range(len(self)))
        if self.shuffle:
            self.rng.shuffle(order)
        buf = []
        for i in order:
            buf.append(self.load_raw(i))
            if len(buf) == batch_size:
                yield {
                    "pc1": np.stack([b[0] for b in buf]),
                    "pc2": np.stack([b[1] for b in buf]),
                }
                buf = []


def collate_local(items):
    pc1 = np.stack([it[0] for it in items])
    pc2 = np.stack([it[1] for it in items])
    rot = np.stack([it[2] for it in items])
    anc = np.stack([it[3] for it in items])
    pos = np.stack([it[4] for it in items])
    return {
        "points": np.concatenate([pc1, pc2]).astype(np.float32),
        "sample_inds": np.concatenate([anc, pos]).astype(np.int32),
        "R": rot.astype(np.float32),
    }


class GlobalTrainTriplet:
    """Triplet/quadruplet sampler for global training: query + num_pos
    positives + num_neg negatives (excluding `nonnegtives`) + optional
    'other negative' excluded from all neighborhoods
    (`core/datasets.py:163-233`).
    """

    def __init__(self, basedir, train_file, posnum, negnum, numpts=8192,
                 aug=("Jitter", "RotateSmall", "Rotate1D"), shuffle=True,
                 other_neg=False, seed=0):
        self.basedir = basedir
        self.numpts = numpts
        self.pos_num = posnum
        self.neg_num = negnum
        self.other_neg = other_neg
        self.augmentation = get_augmentations_from_list(list(aug))
        self.dict = get_sets_dict(train_file)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.pyrng = random.Random(seed)

    def __len__(self):
        return len(self.dict)

    def load_pc(self, ind):
        pcfile = os.path.join(self.basedir, self.dict[ind]["query"] + ".bin")
        cloud = load_single_pcfile(pcfile)
        cloud, _ = get_fixednum_pcd(
            cloud, self.numpts, randsample=True, need_downsample=False,
            sortby_dis=True, rng=self.rng,
        )
        for a in self.augmentation:
            cloud = a.apply(cloud, self.rng)
        return cloud.astype(np.float32)

    def __iter__(self):
        order = list(range(len(self)))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in order:
            positives = self.dict[i]["positives"]
            nonneg = self.dict[i]["nonnegtives"]
            if len(positives) < self.pos_num:
                continue
            posind = [positives[j] for j in self.rng.choice(
                len(positives), size=self.pos_num, replace=False)]
            possible = list(set(self.dict.keys()) - set(nonneg))
            negind = [possible[j] for j in self.rng.choice(
                len(possible), size=self.neg_num, replace=False)]

            query = self.load_pc(i)
            pos = np.concatenate([self.load_pc(j) for j in posind])
            neg = np.concatenate([self.load_pc(j) for j in negind])
            if not self.other_neg:
                yield [query, pos, neg]
            else:
                neighbors = list(positives)
                for n in negind:
                    neighbors.extend(self.dict[n]["positives"])
                possible = list(set(self.dict.keys()) - set(neighbors))
                self.pyrng.shuffle(possible)
                otherneg = self.load_pc(possible[0])
                yield [query, pos, neg, otherneg]

    def batches(self, batch_size) -> Iterator[dict]:
        """Collate into the tuple-concat layout
        [query*B | pos*B*P | neg*B*Nn | otherneg*B] of
        `core/model.py:139-146`."""
        buf = []
        for item in self:
            buf.append(item)
            if len(buf) == batch_size:
                yield collate_global(buf, self.numpts)
                buf = []


def collate_global(items, numpts):
    q = np.stack([it[0] for it in items])
    pos = np.concatenate(
        [it[1].reshape(-1, numpts, 3) for it in items])
    neg = np.concatenate(
        [it[2].reshape(-1, numpts, 3) for it in items])
    parts = [q, pos, neg]
    if len(items[0]) == 4:
        parts.append(np.stack([it[3] for it in items]))
    return {"points": np.concatenate(parts).astype(np.float32)}


class LocalTestDataset:
    """Eval-time cloud loader with fixed-size normalization + optional host
    knn (`core/datasets.py:60-100`)."""

    def __init__(self, basedir, numpts=2 * 8192, knn_require=8, dim=6,
                 seed=0):
        assert os.path.isdir(basedir)
        self.basedir = basedir
        self.files = sorted(glob.glob(os.path.join(basedir, "*.bin")))
        self.knn = knn_require
        self.numpts = numpts
        self.dim = dim
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        from scipy.spatial import cKDTree

        for pcfile in self.files:
            cloud = load_single_pcfile(pcfile, dim=self.dim)
            ori_num = cloud.shape[0]
            if ori_num != self.numpts:
                cloud, ori_num = get_fixednum_pcd(
                    cloud, self.numpts, randsample=False,
                    need_downsample=True, rng=self.rng,
                )
            else:
                choice = self.rng.choice(cloud.shape[0], self.numpts,
                                         replace=False)
                cloud = cloud[choice, :]
            ret = [cloud, os.path.basename(pcfile), ori_num]
            if self.knn > 0:
                _, knn_ind = cKDTree(cloud).query(
                    cloud, k=list(range(1, self.knn + 1)))
                ret.append(knn_ind.astype(np.int32))
            yield ret


class GlobalTestDataset:
    """Sequence-ordered eval loader (`core/datasets.py:236-274`)."""

    def __init__(self, basedir, test_file, numpts=4096 * 2,
                 eval_sequences: Optional[List[str]] = None, seed=0):
        assert os.path.isdir(basedir)
        self.basedir = basedir
        self.testdict = get_sets_dict(test_file)
        self.numpts = numpts
        self.sequences = sorted(
            eval_sequences if eval_sequences is not None
            else self.testdict.keys()
        )
        self.files = [
            pcd["query"] + ".bin"
            for seq in self.sequences
            for pcd in self.testdict[seq]
        ]
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for name in self.files:
            pcd = load_single_pcfile(os.path.join(self.basedir, name))
            if pcd.shape[0] != self.numpts:
                pcd, _ = get_fixednum_pcd(
                    pcd, self.numpts, randsample=True,
                    need_downsample=False, sortby_dis=True, rng=self.rng,
                )
            yield [pcd, name]
