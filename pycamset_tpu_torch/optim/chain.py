"""OptimFunction: a chain of function blocks and its parameter layout.

Counterpart of ``pycamset_tpu/optim/chain.py``. The layout code is host
numpy and unchanged (``ParamStruct.build_cols``: the per-detection gather
rows of the generic backend, ``optim/residuals.py``); the per-detection
chain evaluates on tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pycamset_tpu_torch.optim.blocks import FunctionBlock, ParamSpec, key_type


@dataclass
class ParamStruct:
    """Global parameter layout for a block chain on a given problem size.

    The full parameter vector is the concatenation of each unique param
    group's (count, n) table, in order of first appearance in the chain —
    e.g. [intr 9/cam | extr 6/cam | pose 6/im].
    """
    groups: list[ParamSpec]
    counts: list[int]
    starts: np.ndarray = field(init=False)
    total: int = field(init=False)

    def __post_init__(self):
        sizes = [g.n * c for g, c in zip(self.groups, self.counts)]
        self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.total = int(np.sum(sizes))

    def group_slice(self, gi: int) -> slice:
        return slice(int(self.starts[gi]),
                     int(self.starts[gi]) + self.groups[gi].n * self.counts[gi])

    def build_cols(self, cam_idx: np.ndarray, im_idx: np.ndarray,
                   key_idx: np.ndarray,
                   group_idx: np.ndarray | None = None) -> np.ndarray:
        """Per-detection gather indices into the full parameter vector.

        :param group_idx: per-detection PER_GROUP index (required iff the
            chain has PER_GROUP parameters).
        :return: (N, L) int32 where L = sum of unique-group param counts.
        """
        link_cols = {key_type.PER_CAM: cam_idx, key_type.PER_IMG: im_idx,
                     key_type.PER_KEY: key_idx, key_type.PER_GROUP: group_idx}
        parts = []
        for g, start in zip(self.groups, self.starts):
            if g.link == key_type.SINGLE:
                idx = np.zeros_like(cam_idx)
            else:
                idx = link_cols[g.link]
                if idx is None:
                    raise ValueError(
                        f"chain needs a {g.link.name} index column (the "
                        "handler's group_of_key() gives none)"
                        if g.link == key_type.PER_GROUP else
                        f"chain needs a {g.link.name} index column")
            parts.append(start + idx[:, None] * g.n + np.arange(g.n)[None, :])
        return np.concatenate(parts, axis=1).astype(np.int32)


class OptimFunction:
    """A chain of function blocks, evaluated right-to-left."""

    def __init__(self, blocks: list[FunctionBlock]):
        self.blocks = list(blocks)
        # dedupe param groups by spec, order of first appearance
        self.groups: list[ParamSpec] = []
        self.block_group: list[int] = []
        for b in self.blocks:
            if b.params in self.groups:
                self.block_group.append(self.groups.index(b.params))
            else:
                self.block_group.append(len(self.groups))
                self.groups.append(b.params)
        offs = np.concatenate([[0], np.cumsum([g.n for g in self.groups])])
        self.local_slices = [slice(int(a), int(b))
                             for a, b in zip(offs[:-1], offs[1:])]
        self.local_len = int(offs[-1])
        self.templated = any(b.template for b in self.blocks)
        # per-detection auxiliary input channels (the normalised image row
        # of a rolling-shutter chain, ``blocks.RSTemplateTime``); they ride
        # extra columns of the observation grid
        self.aux_width = max(
            (getattr(b, "aux_inputs", 0) for b in self.blocks), default=0)

    def __add__(self, other):
        if isinstance(other, FunctionBlock):
            return OptimFunction(self.blocks + [other])
        if isinstance(other, OptimFunction):
            return OptimFunction(self.blocks + other.blocks)
        return NotImplemented

    def can_make_jac(self) -> bool:
        return True  # torch.func.jacfwd exists for every chain of blocks

    def _eval_chain(self, params_of, template_pt, aux):
        """The chain right to left, block b reading ``params_of(g)`` for
        its group g."""
        inp = None
        for b, gi in zip(reversed(self.blocks), reversed(self.block_group)):
            src = (template_pt if b.template
                   else (None if b.num_inp == 0 else inp))
            if getattr(b, "aux_inputs", 0):
                inp = b.compute(params_of(gi), src, aux)
            else:
                inp = b.compute(params_of(gi), src)
        return inp

    def make_point_fn(self):
        """The fused prediction function.

        :return: fn(local_params (..., L), template_pt (..., 3)[, aux
            (..., A)]) -> (..., num_out), typically the predicted pixel
            (..., 2); the leading dims broadcast. The ``aux`` argument
            exists only when the chain has aux-consuming blocks
            (``aux_width > 0``: the rolling-shutter row channel).
        """
        slices = self.local_slices

        def eval_local(local_params, template_pt, aux):
            return self._eval_chain(lambda gi: local_params[..., slices[gi]],
                                    template_pt, aux)

        if self.aux_width:
            return eval_local

        def point_fn(local_params, template_pt):
            return eval_local(local_params, template_pt, None)

        return point_fn

    def make_group_point_fn(self):
        """The prediction function on one tensor a parameter group:
        fn(params (list: group g's (..., n_g), in ``groups`` order),
        template_pt (..., 3), aux (..., A) or None) -> (..., num_out). The
        groups' leading dims broadcast against each other and the points
        (a block's camera and pose rows (B, 1, n) against its keys' (1, K,
        n)), so a block's own work is done once a block."""
        def point_fn(params, template_pt, aux=None):
            return self._eval_chain(lambda gi: params[gi], template_pt, aux)

        return point_fn

    def make_local_assembler(self):
        """fn(cam_p, im_p, key_p) -> chain-group-ordered local vector
        (..., L) from the per-link pieces ([cam cols | im cols | key
        cols], each link's groups in chain order)."""
        plan = []
        cursor = {}
        for g in self.groups:
            link = (key_type.PER_KEY if g.link == key_type.PER_GROUP
                    else g.link)
            s = cursor.get(link, 0)
            plan.append((link, s, g.n))
            cursor[link] = s + g.n

        def assemble(cam_p, im_p, key_p):
            src = {key_type.PER_CAM: cam_p, key_type.PER_IMG: im_p,
                   key_type.PER_KEY: key_p}
            return torch.cat(
                [src[link][..., s:s + n] for link, s, n in plan], dim=-1)

        return assemble

    def param_struct(self, n_cams: int, n_ims: int, n_keys: int,
                     n_groups: int = 0) -> ParamStruct:
        """Instantiate the global parameter layout for a problem size."""
        count_of = {key_type.PER_CAM: n_cams, key_type.PER_IMG: n_ims,
                    key_type.PER_KEY: n_keys, key_type.SINGLE: 1,
                    key_type.PER_GROUP: n_groups}
        return ParamStruct(self.groups, [count_of[g.link] for g in self.groups])
