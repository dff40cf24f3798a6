"""Height-sharded maps over a mesh's spatial axis (the JAX package's
``("data", "spatial")`` mesh, which GSPMD partitions; the port does it by
hand).

Inside :func:`banded` the S ranks of a spatial group each hold a band of
the rows of every map whose global height H divides into S bands of at
least MIN_BAND_ROWS rows: rank i holds rows [i H/S, (i+1) H/S). A smaller
map, or one whose height S does not divide, is held whole by every rank of
the group. The layers ask this module what to do:

- a window op (a convolution, a pool) on a band takes ``top`` rows from the
  rank above and ``bottom`` from the rank below (:class:`HaloExchange`;
  the image's own padding at the first and last band), runs VALID along
  the rows and keeps its band's output rows. Where the band cannot supply
  that (a stride-2 op on a band that starts on an odd row, a halo taller
  than the band, an output too small to cut) the map is gathered
  (:class:`GatherRows`), every rank computes it whole, and the output is
  cut again where its height allows (:func:`window`);
- a transposed convolution (PWC-Net's 2x upsampler) takes one row from
  each neighbour and keeps its band's output rows (:func:`transpose_window`);
- a band's cost volume reads the right features ``md`` rows beyond it:
  their halo, or the whole map where md exceeds the band
  (:func:`correlation_rows`), and a band's feature warp samples the whole
  map (:func:`whole`);
- a mean over the rows sums the bands (:class:`SumOverGroup`), and a loss
  term divides its band's sum by the global count (:func:`band_mean`); a
  value that every rank holds (a regularizer of the replicated weights)
  counts on the group's first rank only (:func:`first_rank_share`);
- a loss term at full resolution (the cmb, md2 and md2cmb terms) resizes
  each scale's band of views through the gathered map (:func:`resize`)
  and cuts the whole target to its band (:func:`like`);
- every rank holds the batch's frames whole (:func:`register_frames`):
  each samples the source frames at its band's reprojected pixels.

A rank's loss is its bands' share of the global loss, so every value that
all ranks of a group hold (a pose, a squeeze-excite vector, a gathered
map) gets only its rank's share of the cotangent; the backward of each
collective sums those shares, and the step sums the parameter gradients
over the whole mesh.

A map is a plain tensor. Which maps are bands is kept per local
(rows, width): the step registers its inputs, every op here its output,
and a shape that would be both a band and a whole map raises. Outside
:func:`banded` nothing here is called: every layer runs its one-process
code.

The collectives are all-reduces of a zero buffer with one slot per rank
(exact: each slot has one non-zero contribution), in float32 at least: the
one collective that gloo also runs on card tensors, as
``layers._GlobalBatchNorm`` uses it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the fewest rows of a band: a 2-row band holds a stride-2 window's output
# row and its 5x5 halo, and keeps a band's rows apart from a smaller map's
MIN_BAND_ROWS = 2


@dataclasses.dataclass
class BandStats:
    """What the spatial collectives moved and took since the context
    began: bytes of their all-reduce buffers (``resize_bytes`` the gathers
    of :func:`resize`'s bilinear route, ``gather_bytes`` the others), and
    (with ``timed``) host seconds in them after a device synchronize."""

    halo_bytes: int = 0
    gather_bytes: int = 0
    resize_bytes: int = 0
    sum_bytes: int = 0
    seconds: float = 0.0
    calls: int = 0


class Band:
    """The spatial group of the running step and its map registry."""

    def __init__(self, group, index: int, size: int, timed: bool = False):
        self.group = group
        self.index = index
        self.size = size
        self.timed = timed
        self.stats = BandStats()
        self._rows: dict[tuple[int, int], int] = {}

    # ---- the registry -------------------------------------------------
    def bandable(self, rows: int) -> bool:
        """True where a map of ``rows`` global rows is held as bands."""
        return rows % self.size == 0 and rows // self.size >= MIN_BAND_ROWS

    def register(self, local_rows: int, width: int, rows: int) -> None:
        known = self._rows.setdefault((local_rows, width), rows)
        if known != rows:
            raise NotImplementedError(
                f"a map of {local_rows}x{width} local rows and columns is both of "
                f"{known} and of {rows} global rows on the spatial mesh")

    def global_rows(self, local_rows: int, width: int) -> int | None:
        return self._rows.get((local_rows, width))

    def first_row(self, rows: int) -> int:
        return self.index * (rows // self.size)

    def is_last(self) -> bool:
        return self.index == self.size - 1

    # ---- the collective -----------------------------------------------
    def slots(self, piece: torch.Tensor, kind: str) -> torch.Tensor:
        """[S, *piece.shape]: every rank's ``piece`` (float32 at least)."""
        buf = piece.new_zeros((self.size,) + tuple(piece.shape), dtype=_wide(piece.dtype))
        buf[self.index] = piece
        self.all_reduce(buf, kind)
        return buf

    def all_reduce(self, buf: torch.Tensor, kind: str) -> None:
        if self.timed and buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=self.group)
        if self.timed:
            if buf.is_cuda:
                torch.cuda.synchronize(buf.device)
            self.stats.seconds += time.perf_counter() - t0
        nbytes = buf.numel() * buf.element_size()
        setattr(self.stats, f"{kind}_bytes", getattr(self.stats, f"{kind}_bytes") + nbytes)
        self.stats.calls += 1


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a collective moves ``dtype`` in: float32 at least."""
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def _summed(t: torch.Tensor, band: Band, kind: str) -> torch.Tensor:
    """``t`` summed over the group, in ``t``'s dtype (a copy)."""
    total = t.to(_wide(t.dtype), copy=True)
    band.all_reduce(total, kind)
    return total.to(t.dtype)


_band: Band | None = None


def current() -> Band | None:
    """The band context of the running step, or None."""
    return _band


@contextlib.contextmanager
def banded(mesh, timed: bool = False):
    """For the block, the maps of ``mesh``'s spatial group are held as
    bands (nothing changes on a mesh without a spatial axis). Yields the
    :class:`Band`, or None."""
    global _band
    if mesh is None or mesh.spatial == 1:
        yield None
        return
    outer, _band = _band, Band(mesh.spatial_group, mesh.spatial_index, mesh.spatial, timed)
    try:
        yield _band
    finally:
        _band = outer


# ---- the three autograd functions -------------------------------------

class HaloExchange(torch.autograd.Function):
    """A band along ``dim`` with ``top`` rows of the rank above before it
    and ``bottom`` rows of the rank below after it (``fill`` beyond the
    image's first and last rows). The backward sends each halo row's
    gradient back to its owner, which adds it."""

    @staticmethod
    def forward(ctx, x, top, bottom, dim, fill, band):
        rows = x.shape[dim]
        piece = torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, rows - top, top)], dim)
        buf = band.slots(piece, "halo").to(x.dtype)
        parts = []
        if top:
            parts.append(x.new_full(x.narrow(dim, 0, top).shape, fill) if band.index == 0
                         else buf[band.index - 1].narrow(dim, bottom, top))
        parts.append(x)
        if bottom:
            parts.append(x.new_full(x.narrow(dim, 0, bottom).shape, fill) if band.is_last()
                         else buf[band.index + 1].narrow(dim, 0, bottom))
        ctx.top, ctx.bottom, ctx.dim, ctx.band, ctx.rows = top, bottom, dim, band, rows
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, dim, band, rows = ctx.top, ctx.bottom, ctx.dim, ctx.band, ctx.rows
        g_top = grad.narrow(dim, 0, top)
        g_bottom = grad.narrow(dim, top + rows, bottom)
        if band.index == 0:
            g_top = torch.zeros_like(g_top)
        if band.is_last():
            g_bottom = torch.zeros_like(g_bottom)
        buf = band.slots(torch.cat([g_top, g_bottom], dim), "halo").to(grad.dtype)
        dx = grad.narrow(dim, top, rows).clone()
        if top and not band.is_last():  # the rank below's top halo: my last rows
            dx.narrow(dim, rows - top, top).add_(buf[band.index + 1].narrow(dim, 0, top))
        if bottom and band.index > 0:   # the rank above's bottom halo: my first rows
            dx.narrow(dim, 0, bottom).add_(buf[band.index - 1].narrow(dim, top, bottom))
        return dx, None, None, None, None, None


class GatherRows(torch.autograd.Function):
    """The whole map from its bands along ``dim``; the backward sums the
    ranks' cotangents of the whole map and keeps this band's rows. Its
    bytes count as ``kind`` in :class:`BandStats`."""

    @staticmethod
    def forward(ctx, x, dim, band, kind):
        buf = band.slots(x, kind).to(x.dtype)
        ctx.dim, ctx.band, ctx.rows, ctx.kind = dim, band, x.shape[dim], kind
        return torch.cat(buf.unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        total = _summed(grad, ctx.band, ctx.kind)
        return total.narrow(ctx.dim, ctx.band.index * ctx.rows, ctx.rows), None, None, None


class SumOverGroup(torch.autograd.Function):
    """The sum of ``x`` over the group's ranks; its backward sums the ranks'
    shares of the cotangent the same way."""

    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        return _summed(x, band, "sum")

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.band, "sum"), None


# ---- what the layers call ---------------------------------------------

def _rows_dim(x: torch.Tensor, dim: int) -> tuple[int, int]:
    dim = dim % x.dim()
    return dim, x.shape[dim + 1] if dim + 1 < x.dim() else 1


def state(x: torch.Tensor, dim: int = -2) -> tuple[int, bool] | None:
    """(global rows, is a band) of the map ``x`` (rows along ``dim``, the
    width the axis after it), or None outside a band context or for a map
    the step never registered."""
    band = _band
    if band is None:
        return None
    dim, width = _rows_dim(x, dim)
    rows = band.global_rows(x.shape[dim], width)
    if rows is None:
        return None
    return rows, rows != x.shape[dim]


def register(x: torch.Tensor, rows: int, dim: int = -2) -> torch.Tensor:
    """Note that ``x`` (a band or whole) is a map of ``rows`` global rows."""
    band = _band
    if band is not None:
        dim, width = _rows_dim(x, dim)
        band.register(x.shape[dim], width, rows)
    return x


def global_rows(x: torch.Tensor, dim: int = -2) -> int:
    """The global rows of the map ``x``: its own rows outside a band
    context."""
    known = state(x, dim)
    return x.shape[dim] if known is None else known[0]


def first_row(x: torch.Tensor, dim: int = -2) -> int:
    """The global row of the map ``x``'s first row: 0 but for a band."""
    known = state(x, dim)
    return 0 if known is None or not known[1] else _band.first_row(known[0])


def cut(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """This rank's band of a whole map (registered)."""
    band = _band
    rows = x.shape[dim]
    out = x.narrow(dim, band.first_row(rows), rows // band.size)
    return register(out, rows, dim)


def to_band(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """``x`` cut to this rank's band where the context holds its height as
    bands and ``x`` is whole; else ``x`` (registered)."""
    band = _band
    if band is None:
        return x
    known = state(x, dim)
    if known is not None and known[1]:
        return x
    rows = x.shape[dim] if known is None else known[0]
    if band.bandable(rows):
        return cut(x, dim)
    return register(x, rows, dim)


def whole(x: torch.Tensor, dim: int = -2, kind: str = "gather") -> torch.Tensor:
    """The whole map of a band (registered); ``x`` itself otherwise."""
    known = state(x, dim)
    if known is None or not known[1]:
        return x
    if not x.requires_grad:
        with torch.no_grad():
            out = GatherRows.apply(x, dim % x.dim(), _band, kind)
    else:
        out = GatherRows.apply(x, dim % x.dim(), _band, kind)
    return register(out, known[0], dim)


def like(x: torch.Tensor, ref: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """``x`` (whole) cut to a band where ``ref`` is one."""
    known = state(ref, dim)
    if known is not None and known[1] and x.shape[dim] == known[0]:
        return cut(x, dim)
    return x


def window(x: torch.Tensor, kernel: int, stride: int, pads: tuple[int, int], op,
           fill: float = 0.0) -> torch.Tensor:
    """A window op along the rows (dim -2) of the map ``x`` under the band
    context: ``op`` maps the rows it reads, padded along the rows already,
    to its output, VALID along the rows (it pads the columns itself).
    ``kernel`` is the window's extent in rows (dilation included) and
    ``pads`` the op's global (top, bottom) padding, filled with ``fill``.
    The output is a band where its height allows."""
    band = _band
    known = state(x)
    if known is None:
        raise NotImplementedError(
            f"a {tuple(x.shape)} map reached a window op on the spatial mesh without "
            "a known global height")
    rows, is_band = known
    local = x.shape[-2]
    top = pads[0]
    bottom = max(kernel - stride - top, 0)
    out_rows = (rows + pads[0] + pads[1] - kernel) // stride + 1
    if (is_band and band.bandable(out_rows) and rows % stride == 0 and local % stride == 0
            and out_rows // band.size == local // stride and pads[1] == bottom
            and top <= local and bottom <= local):
        ext = HaloExchange.apply(x, top, bottom, x.dim() - 2, fill, band) \
            if top or bottom else x
        out = op(ext).narrow(-2, 0, local // stride)
        return register(out, out_rows)
    xw = whole(x) if is_band else x
    out = op(F.pad(xw, (0, 0, pads[0], pads[1]), value=fill) if any(pads) else xw)
    return cut(out) if band.bandable(out_rows) else register(out, out_rows)


def transpose_window(x: torch.Tensor, kernel: int, stride: int, padding: int,
                     op) -> torch.Tensor:
    """A transposed convolution along the rows (dim -2) of the map ``x``
    under the band context: ``op`` maps the rows it reads to its output,
    VALID along the rows (no row padding; it pads the columns itself), for
    a ``kernel``-row window, ``stride`` and torch's ``padding`` (output row
    o = i * stride - padding + ky). The output of H rows' map has
    stride * H rows, and is a band where its height allows.

    A sibling of :func:`window`, whose rules do not fit it: a window op
    reads rows of its input above and below each output row and keeps
    1/stride of them, a transposed one spreads each input row over
    ``kernel`` output rows, so its band of output rows [stride r0, stride
    (r0 + h)) reads input rows r0 - top .. r0 + h - 1 + bottom (top =
    ceil((kernel - 1 - padding) / stride), bottom = (stride - 1 + padding)
    // stride: one each for PWC-Net's 4x4, stride 2, padding 1) and keeps
    stride * h rows from stride * top + padding of ``op``'s output. The
    frame's outside is zero rows, which add nothing. A halo taller than
    the band, or a whole input, takes the gather rule: the whole map, its
    output computed whole and cut where its height allows."""
    band = _band
    known = state(x)
    if known is None:
        raise NotImplementedError(
            f"a {tuple(x.shape)} map reached a transposed convolution on the spatial mesh "
            "without a known global height")
    rows, is_band = known
    local = x.shape[-2]
    top = -(-(kernel - 1 - padding) // stride)
    bottom = (stride - 1 + padding) // stride
    out_rows = stride * rows
    if is_band and band.bandable(out_rows) and top <= local and bottom <= local:
        ext = HaloExchange.apply(x, top, bottom, x.dim() - 2, 0.0, band)
        out = op(ext).narrow(-2, stride * top + padding, stride * local)
        return register(out, out_rows)
    xw = whole(x) if is_band else x
    out = op(F.pad(xw, (0, 0, top, bottom))).narrow(-2, stride * top + padding, out_rows)
    return cut(out) if band.bandable(out_rows) else register(out, out_rows)


def correlation_rows(cr: torch.Tensor, max_displacement: int) -> tuple[torch.Tensor, int]:
    """The rows of the right features cr [N, C, h, W] that this rank's
    band of a cost volume reads, and their ``row_offset`` (the band's first
    global row minus theirs, as ``ops.correlation`` takes it): cr and 0
    outside a band context or for a whole map. On a band, where md is at
    most its h rows, the halo route: md rows from each neighbour (zeros
    beyond the frame's first and last rows, which add nothing) and offset
    md; else the gathered route: the whole map (:class:`GatherRows`) and
    the band's first row. Each route's backward sums the band's share of
    the rows' gradient (kernel K4's partial dcr) back to their owners."""
    known = state(cr)
    md = max_displacement
    if known is None or not known[1] or md == 0:
        return cr, 0
    if md <= cr.shape[-2]:
        return halo(cr, md, md, -2), md
    return whole(cr), first_row(cr)


def resize(x: torch.Tensor, height: int, width: int, method: str, plain):
    """``plain(x, height, width, method)`` on a map under the band
    context, ``height`` the global rows; the output is a band where its
    height allows. Nearest 2x on a band reads only its own rows; a
    bilinear resize of a band gathers the map (1 to 3 channels where the
    nets resize; the synthesized and flow-warped views of the cmb, md2 and
    md2cmb terms), resizes it whole and cuts it."""
    band = _band
    known = state(x)
    if known is not None and known[1]:
        if method == "nearest" and height == 2 * known[0] and band.bandable(height):
            return register(plain(x, 2 * x.shape[-2], width, method), height)
        x = whole(x, kind="resize")
    out = plain(x, height, width, method)
    return cut(out) if band.bandable(height) else register(out, height)


@contextlib.contextmanager
def suspended():
    """For the block, no band context: the step's work on whole frames
    (the augmentation, the sources' resizes) runs its one-process code."""
    global _band
    outer, _band = _band, None
    try:
        yield
    finally:
        _band = outer


def mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over the rows and columns of [N, C, H, W]: of the whole map
    where ``x`` is a band, which every rank of the group then holds."""
    known = state(x)
    if known is None or not known[1]:
        return torch.mean(x, dim=(2, 3), keepdim=keepdim)
    total = SumOverGroup.apply(torch.sum(x, dim=(2, 3), keepdim=keepdim), _band)
    return total / (known[0] * x.shape[-1])


def band_mean(x: torch.Tensor, dims: tuple, dim: int, of: torch.Tensor | None = None,
              rows: int | None = None) -> torch.Tensor:
    """A loss term's per-sample mean over ``dims`` (rows along ``dim``):
    this rank's share of it. On a band (``x``'s, or that of the map ``of``
    whose rows ``x`` has), its sum over the global count (``rows`` global
    rows, the map's by default); a map every rank holds whole counts on
    the group's first rank only. Outside a band context, ``torch.mean``."""
    band = _band
    if band is None:
        return torch.mean(x, dim=dims)
    known = state(x if of is None else of, dim)
    if known is None or not known[1]:
        mean = torch.mean(x, dim=dims)
        return mean if band.index == 0 else mean * 0.0
    rows = known[0] if rows is None else rows
    count = rows
    for d in dims:
        if d % x.dim() != dim % x.dim():
            count *= x.shape[d]
    return torch.sum(x, dim=dims) / count


def first_rank_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a value that every rank of the group holds
    alike (a regularizer of the replicated weights): the value on the
    group's first rank, zero on the others (so the step's gradient sum
    over the mesh counts it once a data index); ``x`` outside a band
    context."""
    band = _band
    return x if band is None or band.index == 0 else x * 0.0


def halo(x: torch.Tensor, top: int, bottom: int, dim: int, fill: float = 0.0) -> torch.Tensor:
    """A band of ``x`` with its halo rows (see :class:`HaloExchange`)."""
    return HaloExchange.apply(x, top, bottom, dim % x.dim(), fill, _band)


def diff_rows(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, bool]:
    """``x[r] - x[r + 1]`` along ``dim`` for this rank's rows r below the
    image's last, and whether ``x`` was a band."""
    known = state(x, dim)
    if known is None or not known[1]:
        n = x.shape[dim]
        return x.narrow(dim, 0, n - 1) - x.narrow(dim, 1, n - 1), False
    ext = halo(x, 0, 1, dim)
    n = x.shape[dim] - (1 if _band.is_last() else 0)
    return ext.narrow(dim, 0, n) - ext.narrow(dim, 1, n), True


def register_frames(features, spatial_keys) -> None:
    """Note the ``spatial_keys`` frames of a batch (rows along axis 1, or 2
    for [B, N, H, W, C]) as whole maps, which every rank holds."""
    for key in spatial_keys:
        value = features[key]
        dim = 2 if value.dim() >= 5 else 1
        register(value, value.shape[dim], dim)
