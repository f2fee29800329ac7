"""3DMatch-format dataset abstraction.

A port of ``roreg_tpu/data/dataset.py`` (the reference's
``dataops/dataset.py``): a scene directory holds
``PointCloud/cloud_bin_k.ply``, ``PointCloud/gt.log`` (+ ``gt.info``) and
``Keypoints/cloud_bin_kKeypoints.txt`` (keypoint indices). The gt
convention is ``pts0 = R @ pts1 + t`` for pair (id0, id1); ids are strings.

Named dataset groups (demo / 3dmatch / 3dLomatch / ETH / WHU-TLS /
3dm_train_rot / 3dmatch_train) mirror the reference's scene lists.

A scene is read through ``name``, ``pc_ids``, ``pair_ids``, ``get_pc``,
``get_kps``, ``get_transform`` and ``predator_gt``, the interface that
``data.synthetic.SyntheticScene`` shares for scenes held in memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from roreg_tpu_torch.data.ply import read_ply
from roreg_tpu_torch.eval.benchmark import read_scene_gt

__all__ = ["ThreeDMatchDataset", "get_dataset_group", "parse_gt_log", "SCENE_LISTS", "TRAIN_VAL_SCENES"]


def parse_gt_log(fn: str) -> dict[tuple[str, str], np.ndarray]:
    """gt.log -> {(id0, id1): (3, 4) transform} (dataset.parse_gt_fn:60)."""
    with open(fn) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    out = {}
    for k in range(len(lines) // 5):
        head = lines[k * 5].split()
        id0, id1 = str(int(float(head[0]))), str(int(float(head[1])))
        rows = [
            np.fromstring(lines[k * 5 + 1 + r], dtype=np.float64, sep=" ")[:4]
            for r in range(3)
        ]
        out[(id0, id1)] = np.stack(rows, 0)
    return out


@dataclass
class ThreeDMatchDataset:
    """One scene in the 3DMatch directory layout."""

    root: str
    station_num: int
    name: str = ""
    gt_log: str | None = None
    num_keypoints: int = 5000

    def __post_init__(self):
        self.gt_log = self.gt_log or f"{self.root}/PointCloud/gt.log"
        self.gt_info = os.path.splitext(self.gt_log)[0] + ".info"
        self.pair_id2transform = parse_gt_log(self.gt_log)
        self.pair_ids = list(self.pair_id2transform.keys())
        self.pc_ids = [str(k) for k in range(self.station_num)]
        self._kp_cache: dict[str, np.ndarray] = {}

    # ---- clouds ----

    def pc_path(self, pc_id) -> str:
        return f"{self.root}/PointCloud/cloud_bin_{int(pc_id)}.ply"

    def get_pc(self, pc_id) -> np.ndarray:
        p = self.pc_path(pc_id)
        if os.path.exists(p):
            return read_ply(p)
        txt = f"{self.root}/PointCloud/cloud_bin_{int(pc_id)}.txt"
        return np.loadtxt(txt, delimiter=",")

    # ---- gt ----

    def get_transform(self, id0, id1) -> np.ndarray:
        """(4, 4): pts0 = T @ pts1."""
        T = np.eye(4)
        T[:3, :4] = self.pair_id2transform[(str(id0), str(id1))]
        return T

    def predator_gt(self) -> dict | None:
        """The Predator protocol's gt arrays (``eval.benchmark.read_scene_gt``)
        from gt.log and gt.info, or None without gt.info."""
        if not os.path.exists(self.gt_info):
            return None
        return read_scene_gt(self.gt_log, self.gt_info)

    # ---- keypoints ----

    def kps_path(self, pc_id) -> str:
        return f"{self.root}/Keypoints/cloud_bin_{int(pc_id)}Keypoints.txt"

    def get_kps(self, pc_id) -> np.ndarray:
        """(num_keypoints, 3) keypoint coordinates; generated (random subset,
        persisted) when the keypoint file is missing — dataset.get_kps:109."""
        pc_id = str(pc_id)
        if pc_id in self._kp_cache:
            return self._kp_cache[pc_id]
        kp_fn = self.kps_path(pc_id)
        pc = self.get_pc(pc_id)
        if os.path.exists(kp_fn):
            idx = np.loadtxt(kp_fn).astype(np.int64)
        else:
            idx = np.random.permutation(pc.shape[0])[: self.num_keypoints]
            os.makedirs(os.path.dirname(kp_fn), exist_ok=True)
            np.savetxt(kp_fn, idx)
        keys = pc[idx]
        self._kp_cache[pc_id] = keys
        return keys


# scene lists mirror dataops/dataset.py:132-225
_3DMATCH_SCENES = [
    "kitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]
_3DMATCH_NUMS = [60, 60, 60, 55, 57, 37, 66, 38]

# 54 training scenes of the 3DMatch TRAIN split (dataset.py:160-225); the
# '3dm_train_rot' and '3dmatch_train' groups share the list and the
# per-scene fragment counts, differing only in the directory name (the
# *_rot variant stores pre-rotated fragments).
_TRAIN_SCENES = [
    "bundlefusion-apt0", "rgbd-scenes-v2-scene_02", "bundlefusion-office1",
    "sun3d-brown_cogsci_1-brown_cogsci_1", "rgbd-scenes-v2-scene_06",
    "analysis-by-synthesis-apt2-kitchen", "rgbd-scenes-v2-scene_03",
    "bundlefusion-apt1", "sun3d-harvard_c8-hv_c8_3", "bundlefusion-copyroom",
    "sun3d-home_bksh-home_bksh_oct_30_2012_scan2_erika",
    "rgbd-scenes-v2-scene_04", "7-scenes-pumpkin", "rgbd-scenes-v2-scene_01",
    "analysis-by-synthesis-office2-5a", "sun3d-brown_bm_1-brown_bm_1",
    "bundlefusion-apt2", "sun3d-brown_cs_2-brown_cs2", "bundlefusion-office2",
    "sun3d-hotel_sf-scan1", "sun3d-hotel_nips2012-nips_4",
    "bundlefusion-office3", "rgbd-scenes-v2-scene_09",
    "rgbd-scenes-v2-scene_05", "rgbd-scenes-v2-scene_07", "7-scenes-heads",
    "sun3d-harvard_c3-hv_c3_1", "rgbd-scenes-v2-scene_08",
    "sun3d-mit_76_417-76-417b", "sun3d-mit_32_d507-d507_2",
    "sun3d-mit_46_ted_lab1-ted_lab_2", "7-scenes-chess",
    "rgbd-scenes-v2-scene_10", "sun3d-harvard_c11-hv_c11_2",
    "analysis-by-synthesis-apt2-living",
    "sun3d-mit_w20_athena-sc_athena_oct_29_2012_scan1_erika",
    "analysis-by-synthesis-apt1-living", "analysis-by-synthesis-apt1-kitchen",
    "sun3d-mit_dorm_next_sj-dorm_next_sj_oct_30_2012_scan1_erika",
    "7-scenes-stairs", "sun3d-brown_bm_4-brown_bm_4", "bundlefusion-office0",
    "sun3d-harvard_c6-hv_c6_1", "rgbd-scenes-v2-scene_14",
    "rgbd-scenes-v2-scene_12", "analysis-by-synthesis-office2-5b",
    "analysis-by-synthesis-apt2-luke", "7-scenes-office",
    "sun3d-harvard_c5-hv_c5_1", "sun3d-brown_cs_3-brown_cs3",
    "7-scenes-fire", "rgbd-scenes-v2-scene_11",
    "analysis-by-synthesis-apt2-bed", "rgbd-scenes-v2-scene_13",
]
_TRAIN_NUMS = [
    85, 8, 57, 28, 10, 9, 8, 84, 10, 44, 96, 8, 54, 8, 14, 65, 38, 52, 34,
    92, 62, 37, 7, 11, 9, 18, 19, 9, 77, 54, 75, 54, 7, 8, 10, 70, 15, 11,
    26, 24, 32, 60, 15, 6, 7, 17, 19, 90, 20, 34, 36, 6, 10, 4,
]
# held-out validation scenes within the train split (dataset.py:204,216)
TRAIN_VAL_SCENES = [
    "sun3d-brown_bm_4-brown_bm_4", "sun3d-harvard_c11-hv_c11_2",
    "7-scenes-heads", "rgbd-scenes-v2-scene_10", "bundlefusion-office0",
    "analysis-by-synthesis-apt2-kitchen",
]

SCENE_LISTS = {
    "demo": (["kitchen"], [2]),
    "3dmatch": (_3DMATCH_SCENES, _3DMATCH_NUMS),
    "3dLomatch": (_3DMATCH_SCENES, _3DMATCH_NUMS),
    "ETH": (
        ["gazebo_summer", "gazebo_winter", "wood_autumn", "wood_summer"],
        [32, 31, 32, 37],
    ),
    "WHU-TLS": (
        ["Park", "Mountain", "Campus", "RiverBank", "UndergroundExcavation", "Tunnel"],
        [32, 6, 10, 7, 12, 7],
    ),
    "3dm_train_rot": (_TRAIN_SCENES, _TRAIN_NUMS),
    "3dmatch_train": (_TRAIN_SCENES, _TRAIN_NUMS),
}


def get_dataset_group(name: str, origin_dir: str) -> dict:
    """Named dataset factory (dataset.get_dataset_name:132). Returns
    {'wholesetname': name, scene: ThreeDMatchDataset}; training groups
    additionally carry 'valscenes' (dataset.py:204)."""
    if name not in SCENE_LISTS:
        raise NotImplementedError(f"unknown dataset {name}")
    scenes, nums = SCENE_LISTS[name]
    group: dict = {"wholesetname": name}
    if name in ("3dm_train_rot", "3dmatch_train"):
        group["valscenes"] = list(TRAIN_VAL_SCENES)
    for scene, n in zip(scenes, nums):
        if name == "3dLomatch":
            root = f"{origin_dir}/3dmatch/{scene}"
            gt = f"{root}/PointCloud/gtLo.log"
        else:
            root = f"{origin_dir}/{name}/{scene}"
            gt = None
        ds = ThreeDMatchDataset(root, n, gt_log=gt)
        ds.name = f"{name}/{scene}"
        group[scene] = ds
    return group
