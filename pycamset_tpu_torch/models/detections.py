"""TargetDetection: the relational table of feature observations.

Copy of ``pycamset_tpu/models/detections.py`` (pure numpy): rows
[cam_idx, im_num, key..., u, v] with variable-length multi-dim keys,
buffered appends, relational gets by cam/key/im_num, sorting, key
flattening, per-image feature counts and reconstructability analysis, all
as vectorised numpy. The table is the direct input of the block grid
(``optim/structured.py::build_block_arrays``). Plots wait for the plotting
layer (ROADMAP Queue A item 10).
"""
from __future__ import annotations

from copy import copy
from functools import reduce

import numpy as np


class ImageDetection:
    """Keys + image points found in one image; both or neither must be given."""

    def __init__(self, keys=None, image_points=None):
        keys = np.array([] if keys is None else keys)
        image_points = np.array([] if image_points is None else image_points)
        if keys.size == 0 and image_points.size == 0:
            self.has_data = False
            return
        if keys.size == 0 or image_points.size == 0:
            raise ValueError(
                "A detection requires both identifying keys and detected image points.")
        if len(keys) != len(image_points):
            raise ValueError(
                "Detected keys must be the same length as detected points")
        self.has_data = True
        self.keys = keys
        self.image_points = image_points
        self.data_len = len(keys)


class TargetDetection:
    """Stores which camera saw which feature in which image.

    Data layout per row: | cam | im_num | key ... | u | v |  (key is variable
    length; cam is the index into the camera-name list).
    """

    def __init__(self, cam_names: list, data: np.ndarray | None = None, max_ims: int = 0):
        self.cam_names = list(cam_names)
        if len(set(self.cam_names)) != len(self.cam_names):
            raise ValueError("input camera names must be unique")
        self._data = copy(data)
        self._pending: list = []
        self._max_ims = int(max_ims)
        self._absorb_pending()

    # ------------------------------------------------------------ properties

    @property
    def max_ims(self) -> int:
        self._absorb_pending()  # buffered appends count towards the image range
        if self._data is not None and self._data.shape[0]:
            highest = int(self._data[:, 1].max()) + 1
            self._max_ims = max(highest, self._max_ims)
        return self._max_ims

    @max_ims.setter
    def max_ims(self, val):
        self._max_ims = int(val)

    def has_data(self) -> bool:
        self._absorb_pending()
        return self._data is not None

    def get_data(self) -> np.ndarray | None:
        self._absorb_pending()
        return self._data

    # ---------------------------------------------------------------- writes

    def add_detection(self, cam_name, im_num, detection: ImageDetection) -> None:
        """Append one image's detection to the internal buffer."""
        cam_idx = self.cam_names.index(cam_name)
        if not detection.has_data:
            return
        keys2d = np.atleast_2d(detection.keys.astype(float))
        if detection.keys.ndim == 1:
            keys2d = keys2d.T
        n = detection.data_len
        head = np.empty((n, 2))
        head[:, 0] = cam_idx
        head[:, 1] = im_num
        self._pending.append(
            np.hstack([head, keys2d, detection.image_points]))

    def _absorb_pending(self) -> None:
        """Fold any buffered appends into the table (amortised O(1) appends)."""
        if not self._pending:
            return
        fresh = np.concatenate(self._pending, axis=0)
        self._pending.clear()
        self._data = (fresh if self._data is None
                      else np.concatenate([self._data, fresh], axis=0))
        self._max_ims = max(self._max_ims, int(self._data[:, 1].max()) + 1)

    def __add__(self, other: "TargetDetection") -> "TargetDetection":
        if self.cam_names != other.cam_names:
            raise ValueError("To add detections, they must have consistent camera names")
        tables = [t for t in (self.get_data(), other.get_data())
                  if t is not None and t.shape[0]]
        if not tables:
            return self
        merged = TargetDetection(
            self.cam_names,
            tables[0] if len(tables) == 1 else np.concatenate(tables, axis=0))
        merged.max_ims = max(self.max_ims, other.max_ims)
        return merged

    # ----------------------------------------------------------------- reads

    def _mask_for(self, key: str, target) -> np.ndarray:
        if key == "cam":
            return np.isclose(self._data[:, 0], self.cam_names.index(target))
        if key == "im_num":
            return np.isclose(self._data[:, 1], target)
        if key == "key":
            target = np.atleast_1d(target)
            masks = [np.isclose(self._data[:, 2 + i], k)
                     for i, k in enumerate(target) if not np.isclose(k, -1)]
            return reduce(np.logical_and, masks)
        if key == "index":
            mask = np.zeros(self._data.shape[0], dtype=bool)
            mask[target] = True
            return mask
        raise ValueError(f'{key} is not a gettable item: accepted are '
                         f'"cam", "key", "im_num" or "index"')

    @staticmethod
    def _single_selector(direction: dict) -> tuple[str, object]:
        if len(direction) > 1:
            raise ValueError("Can only get one item at a time")
        return next(iter(direction.items()))

    def get(self, **direction) -> "TargetDetection":
        """Subset of detections by cam=<name>, key=<key>, or im_num=<int>."""
        self._absorb_pending()
        key, target = self._single_selector(direction)
        if key not in ("cam", "key", "im_num"):
            raise ValueError(f'{key} is not a gettable item: accepted are '
                             f'"cam", "key", or "im_num"')
        subset = None
        if self._data is not None:
            subset = self._data[self._mask_for(key, target)]
            if not subset.shape[0]:
                subset = None
        return TargetDetection(cam_names=self.cam_names, data=subset,
                               max_ims=self.max_ims)

    def delete_row(self, **direction) -> "TargetDetection":
        """Detection without the rows matching cam/key/im_num/index values."""
        self._absorb_pending()
        key, target = self._single_selector(direction)
        if not isinstance(target, (list, np.ndarray)):
            target = [target]
        drop = reduce(np.logical_or, [self._mask_for(key, t) for t in target])
        return TargetDetection(cam_names=self.cam_names, max_ims=self.max_ims,
                               data=self._data[~drop])

    def delete_col(self, col_id) -> "TargetDetection":
        return TargetDetection(cam_names=self.cam_names, max_ims=self.max_ims,
                               data=np.delete(self.get_data(), col_id, axis=1))

    def get_cam_list(self) -> list["TargetDetection"]:
        return [self.get(cam=name) for name in self.cam_names]

    def get_image_list(self) -> list["TargetDetection"]:
        return [self.get(im_num=i) for i in range(int(self.max_ims))]

    def get_key_list(self) -> list["TargetDetection"]:
        distinct = np.unique(self.get_data()[:, 2:-2], axis=0)
        return [self.get(key=k) for k in distinct]

    # ------------------------------------------------------------- reshaping

    def _flat_key_column(self, rows: np.ndarray) -> np.ndarray:
        """Collapse the (possibly multi-dim) key columns to one ravel index."""
        key_cols = rows[:, 2:-2]
        if key_cols.shape[1] == 1:
            return key_cols[:, 0]
        extents = key_cols.max(axis=0) + 1
        strides = np.append(np.cumprod(extents[::-1])[::-1], 1)[1:]
        return key_cols @ strides

    def sort(self, keys_to_sort, inplace: bool = False):
        """Lexsort by any of 'cam', 'im_num', 'key' (list order = priority)."""
        wanted = keys_to_sort if isinstance(keys_to_sort, list) else [keys_to_sort]
        rows = self.get_data()
        column_of = {
            "cam": lambda: rows[:, 0],
            "im_num": lambda: rows[:, 1],
            "key": lambda: self._flat_key_column(rows),
        }
        try:
            # np.lexsort keys are least-significant first
            criteria = [column_of[name]() for name in reversed(wanted)]
        except KeyError as bad:
            raise ValueError(f"{bad.args[0]} is not an accepted sort key.\n"
                             "Accepted keys are: 'cam', 'key', or 'im_num'")
        ordered = rows[np.lexsort(criteria)]
        if inplace:
            self._data = ordered
            return None
        return TargetDetection(self.cam_names, ordered, self.max_ims)

    def return_flattened_keys(self, keydims) -> "TargetDetection":
        """Flatten multi-dim keys into a single ravel index (numpy order)."""
        rows = self.get_data()
        if rows.shape[1] == 5:
            return self
        strides = np.cumprod(np.append(np.asarray(keydims)[1:], 1)[::-1])[::-1]
        flat = (rows[:, 2:-2] @ strides)[:, None]
        packed = np.hstack([rows[:, :2], flat, rows[:, -2:]])
        return TargetDetection(self.cam_names, packed, self.max_ims)

    # ------------------------------------------------------------- analytics

    def features_per_im_per_cam(self) -> np.ndarray:
        """(n_ims, n_cams) count of detected features."""
        rows = self.get_data()
        counts = np.zeros((int(self.max_ims), len(self.cam_names)))
        np.add.at(counts, (rows[:, 1].astype(int), rows[:, 0].astype(int)), 1)
        return counts

    def parse_detections_to_reconstructable(self, draw_distribution: bool = False):
        """Identify features triangulable (seen >=2x) at each time point.

        :return feature_inds: start index per feature into the viable subset.
        :return im_dst: per-feature, per-image observation counts.
        :return per_feature_count: images in which each feature is visible.
        :return reconstructable_data: the viable subset of the data table.
        """
        if draw_distribution:
            raise NotImplementedError(
                "plots are not ported yet (ROADMAP Queue A item 10)")
        rows = self.sort(["key", "im_num"]).get_data()

        # keep only (im, key) groups observed by at least two cameras
        _, group_of_row, group_sizes = np.unique(
            rows[:, 1:-2], axis=0, return_inverse=True, return_counts=True)
        viable = rows[(group_sizes > 1)[group_of_row]]

        # per-(im,key) observation counts, in table order
        _, first_row, obs_counts = np.unique(
            viable[:, 1:-2], axis=0, return_index=True, return_counts=True)
        order = np.argsort(first_row)
        counts_in_order = obs_counts[order]
        group_starts = first_row[order]

        # where each feature's row-range begins, plus a terminating sentinel
        _, feature_first = np.unique(viable[:, 2:-2], axis=0, return_index=True)
        feature_inds = np.append(np.sort(feature_first), viable.shape[0])

        # scatter each (im,key) group's count into its feature's row of
        # im_dst, packed left-to-right in image order (vectorised equivalent
        # of walking the groups feature by feature)
        im_dst = np.zeros((len(feature_inds) - 1, self.max_ims))
        if len(group_starts):
            feature_of_group = np.searchsorted(
                feature_inds, group_starts, side="right") - 1
            # rank of each group within its feature's contiguous run
            _, run_start = np.unique(feature_of_group, return_index=True)
            within = np.arange(len(group_starts)) - run_start[feature_of_group]
            im_dst[feature_of_group, within] = counts_in_order
        per_feature_count = (im_dst > 0).sum(axis=1)

        return feature_inds, im_dst, per_feature_count, viable
