"""The geometry of the bf16 conv tile (``csrc/conv_phase.cuh``'s bf16 form),
computed here and passed to its kernels.

The bf16 forms of ``update_step``, ``sepconv_gru`` and ``motion_fwd`` run
one cooperative launch of *phases*, each of one or two convolutions, with a
grid barrier between two phases. A block (one an SM) is a producer
warpgroup and ``CONSUMERS`` consumer warpgroups; it computes a *row
segment*, ``BM`` = 64 pixels of one image row (``x0`` .. ``x0 + 63``,
``ceil(W / 64)`` segments a row, the pixels past W masked) x ``block_n``
output channels of one convolution, the whole N of the convolution up to
``MAX_BLOCK_N`` = 256, so that each pixel's im2col column is gathered once
per convolution. Consumer ``c`` takes the columns ``c * block_n / 2``
onward (its ``wgmma`` is m64n{block_n/2}k16). K advances in stages of
``BKH`` = 64 bfloat16 entries through a ring of ``STAGES``. The weights
(B) come by TMA tile loads. The activations (A) come by TMA too where
every part's channels are a multiple of 64 (``a_tma``: a stage is then 64
channels of one tap and part, a 4-D box of the part at the tap's shift,
zero-filled outside the image); otherwise by the producer's ``cp.async``,
each part's copy width set by its pixel stride (``copy_bytes``: 16 bytes,
8 for the lookup's 324 channels, whose 648-byte pixels TMA's 16-byte
stride rule refuses, 4 for the 2-channel flow).

``plan`` gives each convolution its tile; ``plan_array`` flattens it into
the ints the kernels take (``csrc/conv_phase.cuh``'s ``make_program_h``,
which refuses any other); ``waves`` counts a phase's tiles against the
blocks of a launch. ``motion_phases``, ``gru_phases`` and ``step_phases``
are the programs of the three kernels, as ``add_motion_phases``,
``add_gru_phases`` and ``update_step.cu`` build them.
``tests/test_torch_bf16_tile.py`` emulates the tile on these plans.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

from raft_tpu_torch.ops.conv_pack import KC, bf16_block_n, round_up

BM = 64              # pixels a block: a row segment
BKH = 64             # K entries (bfloat16) a stage
CONSUMERS = 2        # consumer warpgroups a block
STAGES = 4           # depth of the ring
MAX_BLOCK_N = 256    # output channels a block
MAX_CONVS = 2        # conv slots a phase
MAX_PARTS = 3        # activation parts a conv
PLAN_INTS = 2 + MAX_PARTS   # ints a conv slot: block_n, a_tma, a copy width a part
# The motion encoder's widths (motion_cuda.WIDTHS) and the flow head's.
MOTION = (256, 192, 128, 64, 126)
FLOW_HEAD_HIDDEN = 256


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution of a program: kernel (ky, kx), the channels of its
    activation parts in K order, its N output channels and its epilogue
    ("relu", "gates", "blend", or "bias": the flow head's N = 2 conv)."""

    name: str
    ky: int
    kx: int
    cins: tuple
    n: int
    epi: str = "relu"

    @property
    def taps(self) -> int:
        return self.ky * self.kx

    @property
    def two_channel(self) -> bool:
        return self.cins == (2,)

    @property
    def krows(self) -> int:
        """Rows of the packed weight matrix (``conv_pack.packed_rows``)."""
        if self.two_channel:
            return round_up(2 * self.taps, KC)
        return self.taps * sum(round_up(c, KC) for c in self.cins)

    @property
    def ldw(self) -> int:
        """Columns of the packed matrix (``conv_pack.pack_conv_bf16``)."""
        return round_up(self.n, bf16_block_n(self.n))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """The tile of one convolution: ``block_n`` output channels a block,
    ``consumer_n`` those of a consumer warpgroup, its
    K ``stages``, whether A comes by TMA (``a_tma``) and each part's
    ``cp.async`` width otherwise (``copies``, bytes)."""

    conv: Conv
    block_n: int
    consumer_n: int
    stages: int
    a_tma: bool
    copies: tuple

    def tiles(self, b: int, h: int, w: int) -> int:
        """Blocks' tiles over a (b, h, w) batch: (row segments) x (N
        tiles)."""
        return b * h * -(-w // BM) * (self.conv.ldw // self.block_n)

    @property
    def routes(self) -> tuple:
        """Each part's A route: "tma", or "cp.async16", "cp.async8" or
        "cp.async4"; the weights' is "tma"."""
        if self.a_tma:
            return ("tma",) * len(self.copies)
        return tuple(f"cp.async{w}" for w in self.copies)


def copy_bytes(conv: Conv) -> tuple:
    """Each part's A copy width in bytes: the widest of 16, 8 and 4 that
    divides its pixel stride (2 bytes a channel), the flow's 4 (4 taps a
    16-byte chunk)."""
    if conv.two_channel:
        return (4,)
    out = []
    for c in conv.cins:
        if c % 4:
            raise ValueError(f"{conv.name}: a part of {c} channels (the tile takes "
                             f"multiples of 4, or one 2-channel part)")
        out.append(16 if c % 8 == 0 else 8)
    return tuple(out)


def a_tma(conv: Conv) -> bool:
    """Whether a stage of A is one TMA box: every part's channels a
    multiple of 64 (so a stage of 64 K entries lies in one tap and part,
    and the 16-byte stride rule holds)."""
    return not conv.two_channel and all(c % BKH == 0 for c in conv.cins)


def plan_conv(conv: Conv) -> ConvPlan:
    stages = -(-conv.krows // BKH)
    block_n = bf16_block_n(conv.n)
    return ConvPlan(conv, block_n, block_n // CONSUMERS, stages, a_tma(conv),
                    copy_bytes(conv))


def plan(phases) -> tuple:
    """Each phase's tuple of ``ConvPlan``s."""
    return tuple(tuple(plan_conv(c) for c in phase) for phase in phases)


def plan_array(phases) -> tuple:
    """The ints the kernels take: for each phase, ``MAX_CONVS`` slots of
    ``PLAN_INTS`` (block_n, a_tma, then each part's copy width, 0 where
    there is no such conv or part)."""
    out = []
    for phase in plan(phases):
        for slot in range(MAX_CONVS):
            if slot < len(phase):
                p = phase[slot]
                out += [p.block_n, int(p.a_tma), *p.copies,
                        *[0] * (MAX_PARTS - len(p.copies))]
            else:
                out += [0] * PLAN_INTS
    return tuple(out)


def waves(phases, b: int, h: int, w: int, blocks: int) -> list:
    """Per phase of a (b, h, w) batch: its tiles and its waves over
    ``blocks`` co-resident blocks."""
    out = []
    for phase in plan(phases):
        tiles = sum(p.tiles(b, h, w) for p in phase)
        out.append({"convs": [p.conv.name for p in phase], "tiles": tiles,
                    "waves": tiles / blocks})
    return out


def motion_phases(cc: int) -> tuple:
    """``add_motion_phases``: convc1 | convf1, convc2 | convf2, conv."""
    c1, c2, f1, f2, co = MOTION
    return ((Conv("convc1", 1, 1, (cc,), c1), Conv("convf1", 7, 7, (2,), f1)),
            (Conv("convc2", 3, 3, (c1,), c2), Conv("convf2", 3, 3, (f1,), f2)),
            (Conv("conv", 3, 3, (c2 + f2,), co),))


def gru_phases(c: int, cxs) -> tuple:
    """``add_gru_phases``: gates then candidate + blend for the 1x5 half
    and then the 5x1 half, over the parts [h | x parts]."""
    phases = []
    for half, (ky, kx) in enumerate(((1, 5), (5, 1))):
        parts = (c, *cxs)
        phases += [(Conv(f"gates{half + 1}", ky, kx, parts, 2 * c, "gates"),),
                   (Conv(f"cand{half + 1}", ky, kx, parts, c, "blend"),)]
    return tuple(phases)


def step_phases(c: int, ci: int, cc: int, flow_head: bool) -> tuple:
    """``update_step.cu``'s program: the motion phases, the GRU's with x =
    (inp, [motion | flow]) and at depth 'mgf' the flow head's two."""
    phases = motion_phases(cc) + gru_phases(c, (ci, MOTION[4] + 2))
    if flow_head:
        phases += ((Conv("fh1", 3, 3, (c,), FLOW_HEAD_HIDDEN),),
                   (Conv("fh2", 3, 3, (FLOW_HEAD_HIDDEN,), 2, "bias"),))
    return phases


@functools.lru_cache(maxsize=None)
def c_plan(kind: str, *shape) -> tuple:
    """``(ctypes int array, length)`` of ``plan_array`` for the program
    ``kind`` ("motion" (cc), "gru" (c, *cxs) or "step" (c, ci, cc,
    flow_head)), for a kernel call."""
    phases = {"motion": motion_phases,
              "gru": lambda c, *cxs: gru_phases(c, cxs),
              "step": step_phases}[kind](*shape)
    ints = plan_array(phases)
    return (ctypes.c_int * len(ints))(*ints), len(ints)
