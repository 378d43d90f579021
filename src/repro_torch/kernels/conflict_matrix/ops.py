"""Conflict-matrix entry points, mirroring the reference's ``ops``.

Tensor wrappers, over ``int32 [n, 8]`` features (`ref.encode`):

- `conflict_matrix_dense(feat)` -> ``int8 [n, n]`` adjacency;
- `conflict_matrix_words(feat)` -> ``int32 [n, 2*n_words(n)]`` packed
  adjacency words (uint32 bit patterns held as int32).

Tensors on the CPU go to the plain versions (`ref.conflict_matrix_plain`,
`ref.conflict_matrix_packed_groups`); CUDA tensors go to the kernels
(``csrc/conflict_matrix.cu``), built at first use, or the call raises.

Vertex-level entry points, over `core.conflict.Vertex` lists:
`conflict_matrix` (bool ``[n, n]``) and `conflict_matrix_packed`
(uint64 ``[n, n_words(n)]``, the rows `BitsetGraph` holds).
By default (``use_cuda=True``) they run the kernel on ``device`` (None
means ``cuda``) and raise where there is no GPU; ``use_cuda=False`` is
the caller's explicit request for the host's numpy oracle (the
reference's ``use_pallas=False``).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from repro_torch.core.bitset import n_words, pack_bool_rows

from .. import count_launch
from .._build import load
from . import ref


def _check(feat: torch.Tensor, name: str) -> None:
    if not isinstance(feat, torch.Tensor):
        raise TypeError(f"{name}: feat must be a torch.Tensor")
    if feat.dtype != torch.int32:
        raise TypeError(f"{name}: feat must be int32, got {feat.dtype}")
    if feat.dim() != 2 or feat.shape[1] != ref.N_FEATURES:
        raise ValueError(f"{name}: feat must be [n, {ref.N_FEATURES}], "
                         f"got {tuple(feat.shape)}")
    if not feat.is_contiguous():
        raise ValueError(f"{name}: feat must be contiguous")
    if feat.shape[0] >= 2**31:
        raise ValueError(f"{name}: more than 2**31 - 1 vertices")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {feat.device}")


def _launch(name: str, symbol: str, tensors: tuple, *ints: int) -> None:
    """Call the C launcher ``symbol`` on ``tensors``' pointers, ``ints``
    and the current stream, with its ctypes signature declared (a
    pointer passed as a plain int would be cut to 32 bits); count the
    launch, or raise."""
    fn = getattr(load("conflict_matrix"), symbol)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + \
        [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    count_launch(name)


def conflict_matrix_dense(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> ``int8 [n, n]`` (1 where the pair conflicts).

    On the card the result is a view of an ``[n, round_up(n, 16)]``
    buffer, so its rows are not contiguous when ``n % 16 != 0``."""
    _check(feat, "conflict_matrix")
    if feat.device.type == "cpu":
        return ref.conflict_matrix_plain(feat)
    n = feat.shape[0]
    # The kernel loads the 32-byte rows as 16-byte halves.
    if feat.data_ptr() % 16:
        feat = feat.clone()
    # A pitch of n rounded up to 16 bytes keeps every 16-byte run of a
    # row aligned for the kernel's vector stores.
    pitch = -(-n // 16) * 16
    out = torch.empty((n, pitch), dtype=torch.int8, device=feat.device)
    if n:
        _launch("conflict_matrix", "conflict_matrix_launch", (feat, out), n,
                pitch)
    return out[:, :n]


def conflict_matrix_words(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> ``int32 [n, 2*n_words(n)]`` packed words, as
    the OR of each row's op-group and place-group masks (`ref`'s module
    docstring): one ``aminmax`` read back for the mixed-radix plan (or
    a sort where the fields' values are too wide or scattered for it), a
    zeroed mask table, then the kernels' scatter and OR."""
    _check(feat, "conflict_matrix_packed")
    if feat.device.type == "cpu":
        return ref.conflict_matrix_packed_groups(feat)
    n = feat.shape[0]
    w32 = 2 * n_words(n)
    out = torch.empty((n, w32), dtype=torch.int32, device=feat.device)
    if n == 0:
        return out
    plan = ref.radix_plan(feat)
    ids = torch.empty((2, n), dtype=torch.int32, device=feat.device)
    if plan is None:
        ids[0], ids[1], rows = ref.sorted_ids(feat)
        plan = (0,) * len(ref.PLAN_FIELDS)
        radix = 0
    else:
        rows, radix = ref.group_rows(plan), 1
    table = torch.zeros((rows, w32), dtype=torch.int32, device=feat.device)
    _launch("conflict_matrix_packed", "conflict_matrix_packed_launch",
            (feat, ids, table, out), n, w32, radix, *plan)
    return out


def _cuda_features(vertices, device) -> torch.Tensor:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"use_cuda=True (the default) runs on a CUDA "
                         f"device, not {dev}; use_cuda=False is the "
                         f"host's numpy oracle")
    if not torch.cuda.is_available():
        raise RuntimeError("use_cuda=True (the default) needs a CUDA GPU, "
                           "and none is available; use_cuda=False is the "
                           "host's numpy oracle")
    return torch.from_numpy(ref.encode(vertices)).to(dev)


def conflict_matrix(vertices, *, use_cuda: bool = True,
                    device=None) -> np.ndarray:
    """core.conflict.Vertex list -> (n, n) bool adjacency of the
    occupancy/clique rules (dense part; dependency edges added by the
    caller)."""
    if not use_cuda:
        return ref.conflict_matrix_ref(ref.encode(vertices))
    adj = conflict_matrix_dense(_cuda_features(vertices, device))
    # The kernel writes 0 and 1 only: a bool view needs one copy back.
    return adj.view(torch.bool).cpu().numpy()


def conflict_matrix_packed(vertices, *, use_cuda: bool = True,
                           device=None) -> np.ndarray:
    """core.conflict.Vertex list -> packed ``uint64 [n, n_words(n)]``
    adjacency rows, the layout `core.bitset.BitsetGraph` holds.

    With ``use_cuda`` the kernel's int32 words are viewed pairwise as
    uint64 on the host (little-endian bit order end to end), so no
    python pack step runs; the host path packs the dense-bool oracle."""
    if not use_cuda:
        return pack_bool_rows(ref.conflict_matrix_ref(ref.encode(vertices)))
    # The low word of each pair holds columns 64k..64k+31, so a uint64
    # view is the row only on a little-endian host (as CUDA hosts are).
    if sys.byteorder != "little":
        raise RuntimeError("use_cuda=True needs a little-endian host")
    feat = _cuda_features(vertices, device)
    n = feat.shape[0]
    w32 = np.ascontiguousarray(conflict_matrix_words(feat).cpu().numpy())
    return w32.view(np.uint64)[:, :n_words(n)]
