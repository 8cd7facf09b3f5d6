"""A structured bundle-adjustment problem on one device.

``BAProblem`` holds a problem's block arrays, start, column masks and loss
on one device (template, self-calibration, pose-free free-point or grouped
chain; the free-point chain's image piece is zero-width) and solves it
with the structured LM; ``MixedProblem`` does the same for the mixed
multi-target chain, with its own pieces and LM ops; ``TiedProblem`` the template chain with
shared intrinsics (``optim/shared_intr.py``: TiedPieces, the folded normal
equations and the tied LM ops). On a card it owns the CUDA graphs of its LM step
(``graph``), one per dense-solve route, dtype and budget: the first solve
captures one, and later solves of the same problem replay it.

Both the bench's problems (``problems.py``) and the user path
(``optim/structured_driver.py::build_structured_problem``) build one, so
there is one LM driver.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pycamset_tpu_torch.ops.cuda_cholesky import psd_opted_in
from pycamset_tpu_torch.optim.chain import OptimFunction, ParamStruct
from pycamset_tpu_torch.optim.structured import (BlockArrays, GroupWidths,
                                                 ParamPieces, group_onehot,
                                                 make_structured_neq)
from pycamset_tpu_torch.optim.structured_lm import (SLMGraph,
                                                    structured_lm_solve)
from pycamset_tpu_torch.optim.structured_mixed import (
    make_mixed_ops, make_mixed_structured_neq, pack_c_axis)


@dataclass
class BAProblem:
    """A structured BA problem (template, self-cal, free-point or grouped
    chain) on one device."""
    op_fun: OptimFunction
    widths: GroupWidths
    struct: ParamStruct
    blocks: BlockArrays
    x0: ParamPieces        # start
    uv: torch.Tensor       # (B, K, 2)
    mask: torch.Tensor     # (B, K)
    tpl: torch.Tensor      # (K, 3) template table; zeros for free points
    colmask: ParamPieces   # 0/1 unfixed masks
    loss: str
    f_scale: float
    loss_semantics: str
    group_of_key: np.ndarray | None = None   # (K,) for the grouped chains
    n_groups: int | None = None
    max_nfev: int = 100
    # the reduced solver: "dense" or "cg" (the structured chains only; the
    # mixed and tied problems solve dense, as in the JAX package)
    reduced_solver: str = "dense"
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    def make_neq(self):
        """The raw builder neq(pieces, uv, mask, tpl, colmask)."""
        return make_structured_neq(
            self.op_fun, self.widths, self.blocks.n_cams, self.blocks.n_ims,
            loss=self.loss, f_scale=self.f_scale,
            group_of_key=self.group_of_key, n_groups=self.n_groups,
            loss_semantics=self.loss_semantics)

    def ops(self):
        """The LM's linear algebra: None for the structured defaults."""
        return None

    def key_operands(self, pieces, colmask):
        """(keyp, kmask): the c-axis rows and their column masks on the key
        grid, as the gram builders take them (the grouped chain's per-group
        rows expanded by the group one-hot)."""
        if self.group_of_key is None:
            return pieces.key, colmask.key
        oh = self.onehot(pieces.key)
        return oh @ pieces.key, oh @ colmask.key

    def onehot(self, like: torch.Tensor) -> torch.Tensor:
        """The (K, G) group one-hot, in the dtype and on the device of
        ``like``."""
        return torch.as_tensor(group_onehot(self.group_of_key, self.n_groups),
                               dtype=like.dtype, device=like.device)

    def neq_fn(self):
        """neq(pieces) -> NormalEq on this problem's data."""
        neq = self.make_neq()
        return lambda p: neq(p, self.uv, self.mask, self.tpl, self.colmask)

    def graph(self, max_nfev: int | None = None) -> SLMGraph:
        """This problem's LM step runner for the dense-solve route in force
        (``PYCAMSET_PALLAS_CHOL``, read now), its dtype, ``max_nfev`` and
        reduced solver:
        captured by its first solve, replayed by the later ones. A graph
        replayed under the other route would run the wrong route, so each
        route has its own."""
        key = (psd_opted_in(), self.x0.cam.dtype, max_nfev or self.max_nfev,
               self.reduced_solver)
        return self.graphs.setdefault(key, SLMGraph())

    def solve(self, max_nfev: int | None = None, graph: bool = True,
              x0: ParamPieces | None = None):
        """The LM solve from ``x0`` (default: the problem's start, pieces of
        its shapes, dtype and device). On a card each LM step is one replay
        of this problem's CUDA graph (``graph``); ``graph=False`` runs the
        uncaptured step, the reference. On the CPU, the host loop."""
        if graph and self.x0.cam.device.type == "cuda":
            graph = self.graph(max_nfev)
        return structured_lm_solve(self.neq_fn(),
                                   self.x0 if x0 is None else x0,
                                   max_nfev=max_nfev or self.max_nfev,
                                   reduced_solver=self.reduced_solver,
                                   ops=self.ops(), graph=graph)

    def rms_px(self, cost) -> float:
        """sqrt(cost / (2 n_real)), as bench.py reports it."""
        return float(np.sqrt(float(cost) / (2 * self.blocks.n_real)))


@dataclass
class MixedProblem(BAProblem):
    """A mixed PER_KEY + PER_GROUP problem (the multi-target
    self-calibration chain): MixedPieces, MixedNormalEq and the mixed LM
    ops (``optim/structured_mixed.py``)."""

    def make_neq(self):
        return make_mixed_structured_neq(
            self.op_fun, self.widths, self.blocks.n_cams, self.blocks.n_ims,
            self.group_of_key, self.n_groups, loss=self.loss,
            f_scale=self.f_scale, loss_semantics=self.loss_semantics)

    def ops(self):
        return make_mixed_ops(group_onehot(self.group_of_key, self.n_groups))

    def key_operands(self, pieces, colmask):
        return pack_c_axis(self.onehot(pieces.key), pieces, colmask,
                           self.widths)


@dataclass
class TiedProblem(BAProblem):
    """A template problem whose cameras share one lens per lens group
    (``shared_intrinsics``): TiedPieces, the untied normal equations (Kernel
    A or B) folded through the tying map, and the tied LM ops
    (``optim/shared_intr.py``). ``x0`` is TiedPieces; ``colmask`` stays
    the untied layout's."""
    layout: object = None   # shared_intr.TiedLayout

    def make_neq(self):
        return self.layout.make_neq(super().make_neq())

    def ops(self):
        from pycamset_tpu_torch.optim.shared_intr import make_tied_ops
        return make_tied_ops(self.layout.onehot)
