"""Spatial parallelism: image rows sharded over the space axis of a 2-D
(data x space) group (counterpart of stf_unet_tpu/parallel/spatial.py).

The JAX package shards the H axis of its inputs over a 'space' mesh
axis and lets GSPMD insert the halo exchanges. Here each rank of a space
group holds a consecutive block of every activation's rows and the
exchanges are written by hand:

  * `halo_rows` gives a rank the rows above and below its block that a
    window op reads (its neighbours' boundary rows; the global edge's
    own padding, zeros or -inf, where there is no neighbour); its
    backward sends the received rows' gradient back to their owners,
    which add it into their boundary rows. A window op runs on the block
    with its own padding and recomputes only its first and last outputs
    from short strips of the halo and the block, so no padded copy of
    the block is kept for its backward (`halo_exchange` builds that copy,
    for blocks too short for strips);
  * `gather_rows` / `scatter_rows` make a level whole on every rank of
    the space group (backward: the ranks' gradients summed, each rank
    keeping its rows) and cut it back (backward: zeros outside the
    rank's rows), for ops that read rows by global index and for levels
    that do not split;
  * `space_sum`, a sum over the space group whose backward is the same
    sum (the dice's per-image sums, losses/dice.py).

`row_sharded(group, height, width)` routes the ops that read neighbouring
rows while a forward runs: ops/conv.Conv2d, ConvTranspose2d, MaxPool2d
and max_pool2d, and ops/resize.resize_bilinear_align_corners consult
ops/conv.row_handler(), the way the int8 path routes convs through
ops/conv.intercept, so models/ keep their code. Ops that keep rows
(pointwise, BN, the pixel LSTMs, 1x1 convs at stride 1, concatenation)
run on the local rows unchanged.

The uneven-rows rule: a level (an activation of global height H) is
split iff H % n_space == 0, each rank holding H / n_space rows;
otherwise every rank of the space group holds the whole level. An op
from a split level to a split level runs on the local rows with halos
when its stride maps the input shards onto the output shards (h_in =
stride * h_out; h_out = stride * h_in for a transposed conv) and its
halo is no taller than a shard; every other op gathers its input rows
(when they are split), computes the whole output on every rank, and
keeps its own rows when the output level is split. Resizes always
gather. So at crop 224 over two ranks the STF levels 224..14 split and
layer4's 7 rows are whole on both ranks. The choice per level, and each
op that gathers or runs on a whole level, is printed once per geometry
(by rank 0).

Gradients: every rank's loss is its share (losses/criterion.py), DDP
averages over the whole world, and a rank's copy of a whole level
carries only its own loss's gradient, so the sum over the ranks is one
process's gradient. The synced BN reduces over the world: a whole level
counts n_space times in both its sums and its row count, which leaves
the statistics and the backward unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stf_unet_tpu_torch.core.mesh import (DATA_AXIS, SPACE_AXIS, DataGroup,
                                          create_2d_mesh, mesh_2d_shape)
from stf_unet_tpu_torch.ops import conv as conv_lib

__all__ = ["DATA_AXIS", "SPACE_AXIS", "create_2d_mesh", "mesh_2d_shape",
           "spatial_sharding", "splits", "halo_rows", "halo_exchange",
           "gather_rows",
           "scatter_rows", "space_sum", "row_sharded", "RowSharding"]


def splits(height: int, n_space: int) -> bool:
    """Whether a level of `height` rows is split over n_space ranks."""
    return height % n_space == 0


def _rows(x, axis: int, n: int, index: int):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"{size} rows do not split over {n} space ranks")
    h = size // n
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(index * h, (index + 1) * h)
    return x[tuple(sl)]


def spatial_sharding(group: DataGroup, x, h_axis: int,
                     batch_axis: Optional[int] = 0):
    """This rank's block of a global array (numpy or tensor): its data
    shard of `batch_axis` (None: x is already the data shard) and its
    space shard of the image rows `h_axis`."""
    if batch_axis is not None:
        x = _rows(x, batch_axis, group.n_data, group.data_index)
    return _rows(x, h_axis, group.n_space, group.space_index)


class _Space:
    """The space group of a rank: its process group, size and index."""

    def __init__(self, group: DataGroup):
        self.pg = group.space_group
        self.n = group.n_space
        self.index = group.space_index

    def all_gather(self, x: torch.Tensor):
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x.contiguous(), group=self.pg)
        return parts

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=self.pg)
        return x


def _space(group) -> _Space:
    return group if isinstance(group, _Space) else _Space(group)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space, above, below, fill):
        ctx.space, ctx.above, ctx.below = space, above, below
        ctx.shape = x.shape
        h = x.shape[-2]
        # my first `below` rows are the upper neighbour's lower halo, my
        # last `above` rows the lower neighbour's upper halo
        parts = space.all_gather(torch.cat(
            [x.narrow(-2, 0, below), x.narrow(-2, h - above, above)],
            dim=-2))
        s, n = space.index, space.n
        edge = list(x.shape[:-2])
        up = (parts[s - 1].narrow(-2, below, above) if s > 0
              else x.new_full(edge + [above, x.shape[-1]], fill))
        down = (parts[s + 1].narrow(-2, 0, below) if s < n - 1
                else x.new_full(edge + [below, x.shape[-1]], fill))
        return up, down

    @staticmethod
    def backward(ctx, g_up, g_down):
        space, above, below = ctx.space, ctx.above, ctx.below
        # the gradient of the rows I received goes back to their owners
        parts = space.all_gather(torch.cat([g_up, g_down], dim=-2))
        dx = g_up.new_zeros(ctx.shape)
        h = dx.shape[-2]
        s, n = space.index, space.n
        if s < n - 1 and above:  # the lower neighbour read my last rows
            dx.narrow(-2, h - above, above).add_(
                parts[s + 1].narrow(-2, 0, above))
        if s > 0 and below:      # the upper neighbour read my first rows
            dx.narrow(-2, 0, below).add_(
                parts[s - 1].narrow(-2, above, below))
        return dx, None, None, None, None


def halo_rows(x: torch.Tensor, rows_above: int, rows_below: int, group,
              fill: float = 0.0):
    """(the upper neighbour's last rows_above rows, the lower
    neighbour's first rows_below rows) of x [..., h, W], this rank's
    rows; `fill` beyond the global edges. `group` is a 2-D DataGroup
    (or its _Space)."""
    return _HaloRows.apply(x, _space(group), rows_above, rows_below, fill)


def halo_exchange(x: torch.Tensor, rows_above: int, rows_below: int,
                  group, fill: float = 0.0) -> torch.Tensor:
    """x with its halo rows: [..., rows_above + h + rows_below, W]."""
    if rows_above == 0 and rows_below == 0:
        return x
    up, down = halo_rows(x, rows_above, rows_below, group, fill)
    return torch.cat([up, x, down], dim=-2)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space, dim):
        ctx.space, ctx.dim, ctx.rows = space, dim, x.shape[dim]
        return torch.cat(space.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        space = ctx.space
        # every rank's copy carried its own loss's gradient: their sum
        total = space.all_reduce(g.to(torch.promote_types(
            g.dtype, torch.float32))).to(g.dtype)
        return (total.narrow(ctx.dim, space.index * ctx.rows,
                        ctx.rows), None, None)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space, dim):
        ctx.space, ctx.dim, ctx.size = space, dim, x.shape[dim]
        return _rows(x, dim, space.n, space.index).contiguous()

    @staticmethod
    def backward(ctx, g):
        space, dim = ctx.space, ctx.dim
        shape = list(g.shape)
        shape[dim] = ctx.size
        dx = g.new_zeros(shape)
        dx.narrow(dim, space.index * g.shape[dim], g.shape[dim]).copy_(g)
        return dx, None, None


def gather_rows(x: torch.Tensor, group, dim: int = -2) -> torch.Tensor:
    """The whole level on every rank of the space group: the ranks' row
    blocks of x concatenated along `dim`."""
    space = _space(group)
    return _Gather.apply(x, space, dim)


def scatter_rows(x: torch.Tensor, group, dim: int = -2) -> torch.Tensor:
    """This rank's row block of a whole level that every rank of the
    space group holds."""
    space = _space(group)
    return _Scatter.apply(x, space, dim)


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space):
        ctx.space = space
        return space.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.space.all_reduce(g), None


def space_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the space group; each rank's loss may read the sum,
    so its backward sums the ranks' gradients too."""
    space = _space(group)
    return _SpaceSum.apply(x, space)


# Geometries whose plan rank 0 has printed.
_REPORTED = set()


class RowSharding:
    """The row-sharded ops of one forward (ops/conv.row_handler()).

    Activations carry only their local rows, so the plan keeps each
    level's global height by its local shape (rows, cols): the input's
    first, then every output a routed op makes; the ops between keep
    the shape and so the level."""

    def __init__(self, group: DataGroup, height: int, width: int):
        self.space = _Space(group)
        self.n = group.n_space
        self.heights: Dict[Tuple[int, int], int] = {}
        self.choices: Dict[Tuple[str, int, int], str] = {}
        self.geometry = (height, width, self.n)
        if not splits(height, self.n):
            raise ValueError(f"input rows {height} do not split over "
                             f"{self.n} space ranks")
        self._note(height, width)

    def local(self, height: int) -> int:
        return height // self.n if splits(height, self.n) else height

    def _note(self, height: int, width: int) -> None:
        key = (self.local(height), width)
        if self.heights.setdefault(key, height) != height:
            raise RuntimeError(
                f"row sharding: local shape {key} stands for levels of "
                f"{self.heights[key]} and {height} rows")

    def height(self, x: torch.Tensor) -> int:
        key = (x.shape[-2], x.shape[-1])
        if key not in self.heights:
            raise RuntimeError(f"row sharding: no routed op made a level "
                               f"of local shape {key}")
        return self.heights[key]

    def _finish(self, kind, y, height, height_out, mode):
        self.choices[(kind, height, height_out)] = mode
        self._note(height_out, y.shape[-1])
        return y

    def _whole(self, kind, x, height, height_out, run):
        """Gather the input rows, compute the whole output, keep this
        rank's rows of a split output."""
        xf = gather_rows(x, self.space) if splits(height, self.n) else x
        y = run(xf)
        if y.shape[-2] != height_out:
            raise RuntimeError(f"{kind}: {y.shape[-2]} rows, expected "
                               f"{height_out}")
        if splits(height_out, self.n):
            y = scatter_rows(y, self.space)
        return self._finish(kind, y, height, height_out,
                            "gathered" if splits(height, self.n)
                            else "whole")

    def window(self, kind: str, x: torch.Tensor, k: int, s: int, p: int,
               fill: float, run) -> torch.Tensor:
        """A window op along H (kernel k, stride s, padding p) whose
        run(x, pad_h) computes it with `pad_h` rows of padding."""
        height = self.height(x)
        height_out = (height + 2 * p - k) // s + 1
        if splits(height, self.n) and splits(height_out, self.n):
            h, h_out = height // self.n, height_out // self.n
            above, below = p, max(0, k - s - p)
            if h == s * h_out and above <= h and below <= h:
                y = self._halo_window(x, h_out, k, s, p, fill, run)
                if y.shape[-2] != h_out:
                    raise RuntimeError(f"{kind}: {y.shape[-2]} local rows, "
                                       f"expected {h_out}")
                return self._finish(kind, y, height, height_out, "halo")
        return self._whole(kind, x, height, height_out,
                           lambda t: run(t, p))

    def _halo_window(self, x, h_out, k, s, p, fill, run):
        """The window op on this rank's block and its halos. The block
        itself runs with the op's own padding (what its backward keeps
        is x, which the op before keeps too); only the first and last
        outputs, which read the neighbours' rows, are recomputed from
        short strips. A block too short for strips runs padded."""
        above, below = p, max(0, k - s - p)
        if above == 0 and below == 0:
            return run(x, p)
        h = x.shape[-2]
        n_top = -(-p // s)                # outputs reading rows above
        first_bot = (h - k + p) // s + 1  # the first reading rows below
        n_bot = max(0, h_out - first_bot)
        top_rows = (n_top - 1) * s + k - p
        bot_start = first_bot * s - p
        if n_top + n_bot > h_out or top_rows > h or (n_bot and bot_start < 0):
            return run(halo_exchange(x, above, below, self.space, fill), 0)
        up, down = halo_rows(x, above, below, self.space, fill)
        parts = []
        if n_top:
            parts.append(run(torch.cat([up, x.narrow(-2, 0, top_rows)],
                                       dim=-2), 0))
        parts.append(run(x, p).narrow(-2, n_top, h_out - n_top - n_bot))
        if n_bot:
            parts.append(run(torch.cat(
                [x.narrow(-2, bot_start, h - bot_start), down], dim=-2), 0))
        return torch.cat(parts, dim=-2)

    def conv2d(self, conv, x: torch.Tensor, weight, bias) -> torch.Tensor:
        if conv.dilation != (1, 1) or conv.padding_mode != "zeros" \
                or isinstance(conv.padding, str):
            raise NotImplementedError(f"row sharding of {conv}")
        (k, _), (s, _), (p, pw) = (conv.kernel_size, conv.stride,
                                   conv.padding)
        return self.window(
            f"conv{k}x{k}s{s}", x, k, s, p, 0.0,
            lambda t, ph: F.conv2d(t, weight, bias, conv.stride, (ph, pw),
                                   conv.dilation, conv.groups))

    def max_pool2d(self, x: torch.Tensor, k: int, s: int, p: int
                   ) -> torch.Tensor:
        return self.window(
            f"maxpool{k}s{s}", x, k, s, p, float("-inf"),
            lambda t, ph: F.max_pool2d(t, k, s, (ph, p)))

    def conv_transpose2d(self, conv, x: torch.Tensor, weight, bias
                         ) -> torch.Tensor:
        if conv.dilation != (1, 1):
            raise NotImplementedError(f"row sharding of {conv}")
        (k, _), (s, _), (p, pw) = (conv.kernel_size, conv.stride,
                                   conv.padding)
        op = conv.output_padding[0]
        kind = f"convT{k}x{k}s{s}"
        height = self.height(x)
        height_out = (height - 1) * s - 2 * p + k + op

        def run(t):
            return F.conv_transpose2d(t, weight, bias, conv.stride,
                                      conv.padding, conv.output_padding,
                                      conv.groups, conv.dilation)

        if splits(height, self.n) and splits(height_out, self.n):
            h, h_out = height // self.n, height_out // self.n
            # output row o reads input rows (o + p - k + 1) / s .. (o + p) / s
            above = max(0, (k - 1 - p) // s)
            below = max(0, (p - 1) // s + 1)
            # the last p outputs read the row below; from the block's last
            # m rows on (output rows s * (h - m) + ...)
            m = (k - 1) // s
            if (h_out == s * h and above == 0 and below <= h and m <= h
                    and p <= h_out):
                y = run(x)
                if below:
                    _, down = halo_rows(x, 0, below, self.space)
                    strip = run(torch.cat([x.narrow(-2, h - m, m), down],
                                          dim=-2))
                    y = torch.cat([y.narrow(-2, 0, h_out - p),
                                   strip.narrow(-2, s * m - p, p)], dim=-2)
                if y.shape[-2] != h_out:
                    raise RuntimeError(f"{kind}: {y.shape[-2]} local rows, "
                                       f"expected {h_out}")
                return self._finish(kind, y, height, height_out, "halo")
        return self._whole(kind, x, height, height_out, run)

    def resize(self, x: torch.Tensor, out_h: int, out_w: int
               ) -> torch.Tensor:
        """Bilinear align-corners resize to the level whose local shape
        is (out_h, out_w): it reads source rows by global coordinate, so
        it gathers."""
        height = self.height(x)
        if (out_h, out_w) not in self.heights:
            raise RuntimeError(f"row sharding: resize to local shape "
                               f"{(out_h, out_w)}, which no level has")
        height_out = self.heights[(out_h, out_w)]
        return self._whole(
            "resize", x, height, height_out,
            lambda t: F.interpolate(t, size=(height_out, out_w),
                                    mode="bilinear", align_corners=True))

    def report(self) -> Optional[str]:
        """The plan of this geometry, once (by global rank 0)."""
        if self.geometry in _REPORTED:
            return None
        _REPORTED.add(self.geometry)
        height, width, n = self.geometry
        levels = sorted(set(self.heights.values()), reverse=True)
        text = (f"spatial rows, {height}x{width} over {n} space ranks: "
                + ", ".join(f"{h} rows " + (f"split {h // n}/rank"
                                             if splits(h, n) else "whole")
                            for h in levels))
        for mode in ("gathered", "whole"):
            ops = sorted({f"{kind} {a}->{b}" for (kind, a, b), m
                          in self.choices.items() if m == mode})
            if ops:
                text += f"; {mode}: " + ", ".join(ops)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(text, flush=True)
        return text


@contextlib.contextmanager
def row_sharded(group: DataGroup, height: int, width: int
                ) -> Iterator[RowSharding]:
    """Within the block a forward runs on this rank's rows of an input
    of `height` x `width` (the rows split over group's space axis): the
    ops that read neighbouring rows exchange halos or gather."""
    plan = RowSharding(group, height, width)
    with conv_lib.rows(plan):
        yield plan
    plan.report()


def cut_rows(group: DataGroup, x, axis: int):
    """This rank's space shard of a data shard's rows (numpy or
    tensor)."""
    return _rows(x, axis, group.n_space, group.space_index)

