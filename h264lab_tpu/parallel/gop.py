"""GOP-parallel × band-parallel encoding over a device mesh.

The batched scale-out of the reference's two parallel axes
(SURVEY.md §2.2): slice-thread fan-out (`src/h264-lab.h:6511-6574`)
becomes the "band" mesh axis (each band an independent slice), and
GOP/frame data parallelism becomes the "gop" axis: G
independent GOP lanes advance in lockstep, each lane encoding one frame
per step against its own reference picture. Closed GOPs (IDR-separated)
make the lanes fully independent, so the whole step is one SPMD program:
zero cross-device collectives except the per-lane band→reference
all-gather that XLA inserts when bands are sharded (motion vectors read
the full reference picture).

Entropy coding and bit packing run on device per (gop, band) shard —
only packed words cross to the host, which stitches NALUs in order
(the analog of the ordered concat at `src/h264-lab.h:6563-6567`).

With fixed QP, a stream encoded GOP-parallel is bit-identical to the
same stream encoded sequentially: the lanes only reorder *work*, not
syntax. `encode_stream` demonstrates that driver pattern.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from h264lab_tpu.bitstream import BitWriter, headers
from h264lab_tpu.bitstream.nal import annexb_nal
from h264lab_tpu.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu.models import mbscan, refstate, wavefront
from h264lab_tpu.models.encoder import PIC_INIT_QP, FrameResult
from h264lab_tpu.ops import bitpack, tables
from h264lab_tpu.rc.ratecontrol import RateControl, filler_nal

# worst-case packed words per MB: spec 7.4.5 caps macroblock_layer() at
# 3200 bits; 128 words = 4096 bits of headroom
WORDS_PER_MB = 128


def make_mesh(n_gop: int, n_band: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert n_gop * n_band <= len(devices), (
        f"mesh {n_gop}x{n_band} needs {n_gop * n_band} devices, "
        f"have {len(devices)}")
    dev = np.array(devices[:n_gop * n_band]).reshape(n_gop, n_band)
    return Mesh(dev, axis_names=("gop", "band"))


@dataclasses.dataclass(frozen=True)
class _GopStageFns:
    """Per-config jitted stage programs for one (G lanes x B bands) step.

    The staged decomposition: tiling, ME+inter-TQ,
    mode selection, symbolization, deblocking, reference prep and bit
    packing each compile as their OWN XLA program instead of one
    monolith. Dispatch between stages costs microseconds; compile cost
    becomes additive, and the symbolize/deblock/pack/ref programs are
    shared between the IDR and P variants of a stream (the monolith
    compiled them twice). Capacity-overflow redo becomes a re-*pack*
    (one small program at a larger static cap_words), not a re-encode."""
    pre: object
    inter: object
    select: object
    sym: object
    deblock: object
    ref: object


@functools.lru_cache(maxsize=32)
def _gop_stage_fns(mb_width: int, band_rows: int, n_bands: int,
                   has_inter: bool, enable_i4x4: bool,
                   enable_partitions: bool, enable_qpel: bool):
    nmb_b = band_rows * mb_width
    nmb = n_bands * nmb_b

    f_inter = functools.partial(
        mbscan.inter_stage_core, mb_width=mb_width, mb_height=band_rows,
        enable_partitions=enable_partitions, enable_qpel=enable_qpel)
    f_select = functools.partial(
        mbscan.select_stage_core, mb_width=mb_width, mb_height=band_rows,
        has_inter=has_inter, enable_i4x4=enable_i4x4)
    f_sym = functools.partial(
        mbscan.symbolize, mb_width=mb_width, mb_height=band_rows,
        has_inter=has_inter)
    f_dbl = functools.partial(
        mbscan.deblock_stage_core, mb_width=mb_width, mb_height=band_rows)

    def tiles(p, t):
        h, w = p.shape
        return (p.reshape(h // t, t, w // t, t).transpose(0, 2, 1, 3)
                .reshape(n_bands, nmb_b, t, t))

    @jax.jit
    def pre_fn(src_y, src_u, src_v):
        """(G, ph, pw) padded planes -> (G, B, nmb_b, t, t) MB tiles
        (tiling on device: only raw pixels cross PCIe)."""
        return (jax.vmap(lambda p: tiles(p, 16))(src_y),
                jax.vmap(lambda p: tiles(p, 8))(src_u),
                jax.vmap(lambda p: tiles(p, 8))(src_v))

    @jax.jit
    def inter_fn(sy, su, sv, refs, qp, qpc, row0s, pmy, pmx):
        def lane(sy_l, su_l, sv_l, ref, qp_l, qpc_l, pmy_l, pmx_l):
            return jax.vmap(
                lambda a, b, c, q, qc, r0, my, mx: f_inter(
                    a, b, c, ref["y_pad"], ref["u_pad"], ref["v_pad"],
                    ref["y4_pad"], q, qc, r0, my, mx)
            )(sy_l, su_l, sv_l, qp_l, qpc_l, row0s, pmy_l, pmx_l)
        return jax.vmap(lane)(sy, su, sv, refs, qp, qpc, pmy, pmx)

    @jax.jit
    def select_fn(sy, su, sv, qp, qpc, steps, a_top, a_left, inter):
        def lane(sy_l, su_l, sv_l, qp_l, qpc_l, inter_l):
            return jax.vmap(
                lambda a, b, c, q, qc, it:
                    f_select(a, b, c, q, qc, steps, a_top, a_left, it)
            )(sy_l, su_l, sv_l, qp_l, qpc_l, inter_l)
        return jax.vmap(lane)(sy, su, sv, qp, qpc, inter)

    @jax.jit
    def sym_fn(st):
        def one(s):
            return f_sym(s["sel"], s["mode16"], s["cmode"], s["i4modes"],
                         s["i4sym_v"], s["i4sym_l"], s["mv4_y"], s["mv4_x"],
                         s["shape"], s["dc_lev"], s["ac_lev"],
                         s["lev_inter"], s["cdc_lev"], s["cac_lev"])
        return jax.vmap(jax.vmap(one))(st)

    @jax.jit
    def deblock_fn(st, qp, qpc, a_top, a_left):
        def one(s, q, qc):
            return f_dbl(s["recon_y"], s["recon_u"], s["recon_v"],
                         s["sel"], s["lev_inter"], s["mv4_y"], s["mv4_x"],
                         q, qc, a_top, a_left)
        return jax.vmap(jax.vmap(one))(st, qp, qpc)

    @jax.jit
    def ref_fn(df_y, df_u, df_v, mv_y, mv_x):
        """(G, B, nmb_b, ...) deblocked tiles -> per-lane reference
        pytrees + flat per-lane df tiles + next-step MV candidates."""
        def lane(dy, du, dv):
            dy = dy.reshape(nmb, 16, 16)
            du = du.reshape(nmb, 8, 8)
            dv = dv.reshape(nmb, 8, 8)
            return refstate.prepare_reference(
                dy, du, dv, mb_width, band_rows * n_bands), (dy, du, dv)
        new_refs, flat = jax.vmap(lane)(df_y, df_u, df_v)
        return new_refs, flat, mv_y >> 2, mv_x >> 2

    return _GopStageFns(pre=pre_fn, inter=inter_fn, select=select_fn,
                        sym=sym_fn, deblock=deblock_fn, ref=ref_fn)


@functools.lru_cache(maxsize=32)
def _gop_pack_fn(cap_words: int):
    @jax.jit
    def pack_fn(sym_vals, sym_lens):
        return jax.vmap(jax.vmap(
            lambda v, l: bitpack.pack_frame_fast(v, l, cap_words)))(
                sym_vals, sym_lens)
    return pack_fn


def _gop_banded_staged(src_y, src_u, src_v, refs, qp, qpc,
                       prev_my, prev_mx,
                       steps, avail_top, avail_left, row0s,
                       mb_width: int, band_rows: int, n_bands: int,
                       has_inter: bool, enable_i4x4: bool,
                       enable_deblock: bool, enable_partitions: bool,
                       enable_qpel: bool, cap_words: int):
    """One encode step for (G gop-lanes × B bands), staged dispatch.
    src_*: (G, ph, pw) padded planes; refs: per-lane reference pytree
    with leading G (or None for intra); qp/qpc: (G, B) per-band slice
    QPs (fine rate control). Returns (out dict, new_refs).

    `cap_words` is a *typical-frame* capacity, not the worst case: the
    caller detects overflow (nbits > 32*cap_words) and re-packs the
    kept symbol arrays at a larger bucket (no re-encode)."""
    fns = _gop_stage_fns(mb_width, band_rows, n_bands, has_inter,
                         enable_i4x4, enable_partitions, enable_qpel)
    sy, su, sv = fns.pre(src_y, src_u, src_v)
    if has_inter:
        inter = fns.inter(sy, su, sv, refs, qp, qpc, row0s,
                          prev_my, prev_mx)
    else:
        inter = None
    st = fns.select(sy, su, sv, qp, qpc, steps, avail_top, avail_left,
                    inter)
    sym = fns.sym(st)
    if enable_deblock:
        df_y, df_u, df_v = fns.deblock(st, qp, qpc,
                                       avail_top, avail_left)
    else:
        df_y, df_u, df_v = st["recon_y"], st["recon_u"], st["recon_v"]
    words, nbits = _gop_pack_fn(cap_words)(sym["sym_vals"],
                                           sym["sym_lens"])
    new_refs, (fdy, fdu, fdv), pmv_y, pmv_x = fns.ref(
        df_y, df_u, df_v, st["mv_y"], st["mv_x"])
    out = dict(words=words, nbits=nbits, total_bits=sym["total_bits"],
               tail_val=sym["tail_val"], tail_len=sym["tail_len"],
               df_y=fdy, df_u=fdu, df_v=fdv,
               pmv_y=pmv_y, pmv_x=pmv_x,
               sym_vals=sym["sym_vals"], sym_lens=sym["sym_lens"])
    return out, new_refs


@dataclasses.dataclass
class _PendingStep:
    out: dict
    qps: list                    # frame-level QP per lane
    band_qps: list               # per-lane [per-band QP] (fine RC)
    is_idr: bool
    run: RunConfig
    n_bands: int
    frame_num: int
    return_recon: bool
    transparent: list = None     # per-lane: emit an all-skip frame
    old_refs: object = None      # the ref predicted from (transparent recon)
    is_intra: bool = False       # I or IDR
    ft_name: str = "P"
    lt_use: int = 0              # long-term policy for the slice headers
    lt_update: int = 0
    hdr_st_used: bool = False    # pre-marking DPB flags
    hdr_lt_in_use: bool = False


class GopBandEncoder:
    """G lockstep GOP lanes × B slice bands in one sharded dispatch.

    Every lane is an independent H.264 stream segment (closed GOPs): lane
    g encodes GOP g of a source stream, or independent streams entirely.
    All lanes share the frame schedule (IDR at step 0 and every `gop`
    steps) but carry their own rate-control state and reference pictures.

    With `mesh`, inputs are placed with ("gop", "band") shardings and the
    step partitions across the mesh; without, the same batched program
    runs on one device (filling it with G×B-wide wavefronts).
    """

    def __init__(self, config: EncoderConfig, n_gop: int | None = None,
                 mesh: Mesh | None = None, idr_pic_id_base: int = 0,
                 per_lane_idr_pic_id: bool = False):
        cfg = config
        self.config = cfg
        self.n_gop = n_gop = (cfg.gop_parallel if n_gop is None else n_gop)
        self.mesh = mesh
        # Standalone lanes are independent streams and all use
        # `idr_pic_id_base`: identical inputs yield byte-identical lane
        # outputs (the driver dryrun invariant). `encode_stream` instead
        # sets per_lane_idr_pic_id so lane g's IDR uses (base + g) mod 16,
        # matching the sequential encoder's one-per-IDR increment
        # (reference `src/h264-lab.h:4266`) for bit-identical stitching.
        self.idr_pic_id_base = idr_pic_id_base
        self.per_lane_idr_pic_id = per_lane_idr_pic_id
        if cfg.mb_height % cfg.slice_bands:
            raise ValueError("slice_bands must divide mb_height")
        # feature parity with H264Encoder is explicit: configs the
        # GOP-parallel path does not implement are rejected, not
        # silently downgraded
        if cfg.temporal_denoise_flag:
            raise ValueError(
                "GopBandEncoder does not support temporal denoising; "
                "pre-filter the input or use H264Encoder")
        self.n_bands = cfg.slice_bands
        self.band_rows = cfg.mb_height // cfg.slice_bands
        self.max_cap_words = 1 << int(np.ceil(np.log2(
            self.band_rows * cfg.mb_width * WORDS_PER_MB)))
        # Packed capacity is sized per frame type (a static shape — each
        # distinct bucket is its own compiled program, so mis-sizing the
        # first dispatch would force a full recompile mid-stream):
        #   - I/IDR frames go straight to the spec worst-case bucket
        #     (WORDS_PER_MB) — intra frames are rare (1/gop), their bits
        #     are content-dependent and can approach the bound (a busy
        #     1080p IDR measures >1000 bits/MB), and the oversized
        #     transfer costs ~ms while an overflow recompile costs
        #     minutes.
        #   - P frames start at a typical ~256 bits/MB bucket; overflow
        #     is detected in finish_step and re-dispatches at a larger
        #     bucket (then sticks there).
        self.idr_cap_words = self.max_cap_words
        self.p_cap_words = max(
            1024, 1 << int(np.ceil(np.log2(
                self.band_rows * cfg.mb_width * 8 + 1))))
        self.frame_num = 0
        self.step_idx = 0
        # per-lane previous-frame full-pel MV fields (G, B, nmb_band) —
        # the ME candidate centre carried across steps (me.py); None
        # right after an IDR (zeros are dispatched, matching the
        # sequential encoder exactly)
        self._prev_mv = None
        self.rc = [RateControl(cfg.n_mb, cfg.gop, cfg.vbv_size_bytes, cfg.qp)
                   for _ in range(n_gop)]
        # reference slots, lane-batched: 0 = short-term, 1..N = long-term
        # slot k holds LongTermFrameIdx k-1 on every lane (the lanes share
        # one frame-type schedule; policy `src/h264-lab.h:6726-6754`)
        self._refs = {}
        self._gop_pos = 0
        self._most_recent_idx = 0
        self._short_term_used = False
        self._lt_used = [False] * cfg.max_long_term_reference_frames
        self._force_transparent = [False] * n_gop
        self._sps = headers.SpsParams(
            width=cfg.width, height=cfg.height,
            mb_width=cfg.mb_width, mb_height=cfg.mb_height,
            sps_id=cfg.sps_id,
            num_ref_frames=1 + cfg.max_long_term_reference_frames,
            vbv_size_bytes=cfg.vbv_size_bytes)
        self._band_plan = {}

    def _plan(self, slope):
        if slope not in self._band_plan:
            plan = wavefront.make_plan(self.config.mb_width,
                                       self.band_rows, slope)
            nmb = self.config.mb_width * self.band_rows
            r = np.arange(nmb) // self.config.mb_width
            c = np.arange(nmb) % self.config.mb_width
            self._band_plan[slope] = (jnp.asarray(plan.steps),
                                      jnp.asarray(r > 0), jnp.asarray(c > 0))
        return self._band_plan[slope]

    def _shard(self, x, spec):
        if self.mesh is None:
            return x
        return jax.device_put(x, NamedSharding(self.mesh, spec))

    def encode_step(self, frames, run: RunConfig | None = None,
                    return_recon: bool = False):
        """Encode one frame on every lane (dispatch + pack). frames: list
        of G (y, u, v) uint8 planes. Returns list of G FrameResult."""
        return self.finish_step(
            self.encode_step_async(frames, run, return_recon))

    def encode_step_async(self, frames, run: RunConfig | None = None,
                          return_recon: bool = False) -> _PendingStep:
        """Dispatch the device computation for one frame on every lane and
        return immediately; `finish_step` packs the bitstreams — so host
        packing of step N overlaps device compute of step N+1 (the same
        two-stage pipeline as H264Encoder.encode_async/finish)."""
        cfg = self.config
        run = run or RunConfig(qp_min=cfg.qp, qp_max=cfg.qp)
        G, B = self.n_gop, self.n_bands
        assert len(frames) == G

        # frame-type -> long-term-slot policy, shared by all lanes
        # (reference `src/h264-lab.h:6726-6754`; same rules as
        # H264Encoder.encode_async)
        n_lt = cfg.max_long_term_reference_frames
        ftype = run.frame_type
        if ftype == FrameType.DEFAULT:
            if self.step_idx == 0 or not self._refs:
                ftype = FrameType.KEY
            elif cfg.gop and self._gop_pos >= cfg.gop:
                ftype = FrameType.KEY
            else:
                ftype = FrameType.P
        if ftype == FrameType.I:
            lt_use, lt_update = -1, 0
        elif ftype == FrameType.KEY:
            lt_use, lt_update = -1, (1 if n_lt > 0 else 0)
        elif ftype == FrameType.GOLDEN:
            lt_use, lt_update = 1, 1
        elif ftype == FrameType.RECOVERY:
            lt_use, lt_update = 1, 0
        elif ftype == FrameType.DROPPABLE:
            lt_use, lt_update = self._most_recent_idx, -1
        elif ftype == FrameType.CUSTOM:
            lt_use = run.long_term_idx_use or self._most_recent_idx
            lt_update = run.long_term_idx_update
            if lt_use < 0:
                ftype = FrameType.KEY
                lt_update = 1 if n_lt > 0 else 0
        else:  # P
            lt_use, lt_update = self._most_recent_idx, 0
        if ftype not in (FrameType.KEY, FrameType.I) \
                and self._refs.get(max(lt_use, 0)) is None:
            ftype = FrameType.KEY
            lt_use, lt_update = -1, (1 if n_lt > 0 else 0)
        is_idr = ftype == FrameType.KEY
        is_intra = ftype in (FrameType.KEY, FrameType.I)
        has_inter = not is_intra

        # VBV overflow policy per lane (reference `src/h264-lab.h:6497`):
        # the lane's frame is replaced by an all-skip "transparent" frame
        # in finish_step (the SPMD step still computes it — rare waste —
        # but its reference/payload are discarded)
        transparent = [self._force_transparent[g] and has_inter
                       and cfg.vbv_overflow_empty_frame_flag
                       for g in range(G)]
        self._force_transparent = [False] * G

        qmin = int(np.clip(run.qp_min, 10, 51))
        qmax = int(np.clip(run.qp_max, 10, 51))
        qps = []
        band_qps = []
        for g in range(G):
            qp = self.rc[g].frame_start(
                not has_inter, run.desired_frame_bytes, qmin, qmax)
            qps.append(qp)
            if cfg.fine_rate_control_flag and B > 1:
                band_qps.append(self.rc[g].band_qp_offsets(
                    B, not has_inter, run.desired_frame_bytes, qmin, qmax))
            else:
                band_qps.append([qp] * B)
        qp_arr = jnp.asarray(np.asarray(band_qps, np.int32))      # (G, B)
        qpc_arr = jnp.asarray(
            np.asarray([[int(tables.QPC_FROM_QPY[q]) for q in row]
                        for row in band_qps], np.int32))

        mbw = cfg.mb_width
        ph, pw = cfg.padded_height, cfg.padded_width
        ys, us, vs = [], [], []
        for (y, u, v) in frames:
            ys.append(wavefront.pad_plane(np.asarray(y, np.uint8), ph, pw))
            us.append(wavefront.pad_plane(np.asarray(u, np.uint8),
                                          ph // 2, pw // 2))
            vs.append(wavefront.pad_plane(np.asarray(v, np.uint8),
                                          ph // 2, pw // 2))
        # (G, ph, pw): lanes over "gop"; rows over "band" (each band's
        # rows are contiguous, so the row axis IS the band axis)
        gb = P("gop", "band")
        src_y = self._shard(jnp.asarray(np.stack(ys)), gb)
        src_u = self._shard(jnp.asarray(np.stack(us)), gb)
        src_v = self._shard(jnp.asarray(np.stack(vs)), gb)

        enable_i4x4 = (not has_inter) or run.encode_speed < 2
        enable_partitions = run.encode_speed < 1
        enable_qpel = run.encode_speed < 9
        enable_deblock = run.encode_speed not in (8, 10)
        steps, a_top, a_left = self._plan(2 if enable_i4x4 else 1)
        row0s = jnp.asarray(
            np.arange(B, dtype=np.int32) * self.band_rows)

        nmb_b = self.band_rows * mbw
        # previous-frame MV candidate: only valid when predicting from
        # the short-term chain (mirrors H264Encoder)
        if has_inter and lt_use == 0 and self._prev_mv is not None:
            pmy, pmx = self._prev_mv
        else:
            pmy = pmx = self._shard(
                jnp.zeros((G, B, nmb_b), jnp.int32), P("gop", "band"))
        ref_used = self._refs.get(max(lt_use, 0)) if has_inter else None
        args = (src_y, src_u, src_v, ref_used,
                self._shard(qp_arr, P("gop")), self._shard(qpc_arr, P("gop")),
                pmy, pmx,
                steps, a_top, a_left, row0s)
        kwargs = dict(mb_width=mbw, band_rows=self.band_rows, n_bands=B,
                      has_inter=has_inter, enable_i4x4=enable_i4x4,
                      enable_deblock=enable_deblock,
                      enable_partitions=enable_partitions,
                      enable_qpel=enable_qpel)
        cap = self.idr_cap_words if is_intra else self.p_cap_words
        out, new_refs = _gop_banded_staged(*args, cap_words=cap, **kwargs)

        # pre-marking DPB flags go into the slice headers (finish_step)
        hdr_st_used = self._short_term_used
        hdr_lt_in_use = (self._lt_used[lt_update - 1]
                         if lt_update > 0 else False)

        # DPB update (lane-batched slots)
        if is_idr:
            self._refs = {}
            self._short_term_used = False
            self._lt_used = [False] * n_lt
        if lt_update >= 0:
            old_slot = self._refs.get(lt_update)
            if any(transparent) and old_slot is not None:
                # transparent lanes keep the slot's previous picture
                mask = jnp.asarray(np.asarray(transparent))
                new_refs = jax.tree_util.tree_map(
                    lambda old, new: jnp.where(
                        mask.reshape((G,) + (1,) * (new.ndim - 1)),
                        old, new),
                    old_slot, new_refs)
            self._refs[lt_update] = new_refs
            self._most_recent_idx = lt_update
            if lt_update == 0:
                self._short_term_used = True
            else:
                self._lt_used[lt_update - 1] = True

        if is_intra or lt_use != 0:
            self._prev_mv = None
        else:
            new_prev = (out["pmv_y"], out["pmv_x"])
            if any(transparent):
                # transparent lanes keep their previous MV field too
                m3 = jnp.asarray(np.asarray(transparent)).reshape(G, 1, 1)
                oldp = self._prev_mv or (jnp.zeros_like(new_prev[0]),
                                         jnp.zeros_like(new_prev[1]))
                self._prev_mv = (jnp.where(m3, oldp[0], new_prev[0]),
                                 jnp.where(m3, oldp[1], new_prev[1]))
            else:
                self._prev_mv = new_prev

        self.step_idx += 1
        self._gop_pos = 1 if is_idr else self._gop_pos + 1
        fn_use = 0 if is_idr else self.frame_num
        self.frame_num = (fn_use + 1) % (1 << headers.FRAME_NUM_BITS)
        ft_name = "IDR" if is_idr else ("I" if is_intra else "P")
        return _PendingStep(out=out, qps=qps, band_qps=band_qps,
                            is_idr=is_idr, run=run,
                            n_bands=B, frame_num=fn_use,
                            return_recon=return_recon,
                            transparent=transparent, old_refs=ref_used,
                            is_intra=is_intra, ft_name=ft_name,
                            lt_use=lt_use, lt_update=lt_update,
                            hdr_st_used=hdr_st_used,
                            hdr_lt_in_use=hdr_lt_in_use)

    def finish_step(self, p: _PendingStep):
        """Pack a dispatched step into per-lane Annex-B bytes."""
        cfg = self.config
        G, B = self.n_gop, p.n_bands
        frame_num = p.frame_num
        return_recon = p.return_recon
        nbits = np.asarray(p.out["nbits"])          # (G, B)
        # capacity overflow (P frames only — IDR dispatches at the spec
        # worst-case bucket): re-PACK the kept symbol arrays at a larger
        # bucket — a small standalone program, no re-encode (rare;
        # buffers and transfers stay sized for the typical frame)
        while (not p.is_intra
               and int(nbits.max(initial=0)) > 32 * self.p_cap_words):
            if self.p_cap_words >= self.max_cap_words:
                raise RuntimeError("packed stream exceeds spec bound")
            need = int(nbits.max()) // 32 + 2
            while self.p_cap_words < min(need * 2, self.max_cap_words):
                self.p_cap_words *= 2
            words, nb = _gop_pack_fn(self.p_cap_words)(
                p.out["sym_vals"], p.out["sym_lens"])
            p.out["words"], p.out["nbits"] = words, nb
            nbits = np.asarray(nb)
        # one plain transfer of the ready buffer: a device-side prefix
        # slice would be a compute op queued BEHIND the next step's
        # program and would serialize the two-stage pipeline
        words = np.asarray(p.out["words"])          # (G, B, cap[+slack])
        tails_v = np.asarray(p.out["tail_val"])     # (G, B)
        tails_l = np.asarray(p.out["tail_len"])     # (G, B)
        deblock_idc = 2 if B > 1 else 0
        results = []
        for g in range(G):
            is_transparent = bool(p.transparent and p.transparent[g])
            payload = b""
            band_bytes = []
            if p.is_idr:
                payload += headers.sps_nal(self._sps)
                payload += headers.pps_nal(cfg.sps_id, 0, PIC_INIT_QP)
            if is_transparent:
                payload += self._transparent_nal(frame_num, p.qps[g])
            else:
                for b in range(B):
                    bw = BitWriter(capacity=1 << 16)
                    shp = headers.SliceHeaderParams(
                        slice_type=(headers.SLICE_TYPE_I if p.is_intra
                                    else headers.SLICE_TYPE_P),
                        is_idr=p.is_idr,
                        frame_num=frame_num,
                        first_mb=b * self.band_rows * cfg.mb_width,
                        pps_id=cfg.sps_id * 4,
                        idr_pic_id=(self.idr_pic_id_base
                                    + (g if self.per_lane_idr_pic_id
                                       else 0)) % 16,
                        slice_qp=p.band_qps[g][b],
                        pic_init_qp=PIC_INIT_QP,
                        disable_deblocking_filter_idc=deblock_idc,
                        long_term_idx_use=(max(p.lt_use, 0)
                                           if not p.is_intra else 0),
                        long_term_idx_update=p.lt_update,
                        short_term_used=p.hdr_st_used,
                        lt_slot_in_use=p.hdr_lt_in_use,
                        max_long_term_frames=
                            cfg.max_long_term_reference_frames)
                    headers.write_slice_header_rbsp(bw, shp)
                    mb_bits = int(nbits[g, b])
                    bw.append_bits_bytes(
                        bitpack.words_to_bytes(words[g, b], mb_bits),
                        mb_bits)
                    if int(tails_l[g, b]):
                        bw.u(int(tails_l[g, b]), int(tails_v[g, b]))
                    bw.rbsp_trailing_bits()
                    ref_idc, nal_type = headers.slice_nal_header_byte(shp)
                    nal = annexb_nal(ref_idc, nal_type, bw.to_bytes())
                    payload += nal
                    band_bytes.append(len(nal))
            actions = self.rc[g].frame_end(
                p.is_intra, len(payload), p.run.desired_frame_bytes,
                band_bytes=band_bytes or None)
            if (actions["stuffing_bytes"]
                    and cfg.vbv_underflow_stuffing_flag):
                payload += filler_nal(actions["stuffing_bytes"])
            if actions["overflow"]:
                self._force_transparent[g] = True
            recon = None
            if return_recon:
                mbh = cfg.mb_height
                if is_transparent:
                    # recon == the lane's (unchanged) reference picture
                    from h264lab_tpu.ops import qpel
                    gy = qpel.GUARD
                    gc = qpel.GUARD // 2
                    ref_g = jax.tree_util.tree_map(lambda a: a[g],
                                                   p.old_refs)
                    ry = np.asarray(ref_g["y_pad"])[gy:-gy, gy:-gy]
                    ru = np.asarray(ref_g["u_pad"])[gc:-gc, gc:-gc]
                    rv = np.asarray(ref_g["v_pad"])[gc:-gc, gc:-gc]
                else:
                    ry = wavefront.tiles_to_plane(
                        np.asarray(p.out["df_y"][g]), mbh, cfg.mb_width)
                    ru = wavefront.tiles_to_plane(
                        np.asarray(p.out["df_u"][g]), mbh, cfg.mb_width)
                    rv = wavefront.tiles_to_plane(
                        np.asarray(p.out["df_v"][g]), mbh, cfg.mb_width)
                recon = (ry[:cfg.height, :cfg.width],
                         ru[:cfg.height // 2, :cfg.width // 2],
                         rv[:cfg.height // 2, :cfg.width // 2])
            results.append(FrameResult(
                payload=payload, frame_type=p.ft_name,
                qp=p.qps[g], recon=recon))
        return results

    def _transparent_nal(self, frame_num: int, qp: int) -> bytes:
        """All-skip P frame for one lane (one slice covering the picture;
        reconstruction equals the reference picture exactly — reference
        `src/h264-lab.h:6497-6508`)."""
        cfg = self.config
        bw = BitWriter()
        shp = headers.SliceHeaderParams(
            slice_type=headers.SLICE_TYPE_P,
            is_idr=False,
            frame_num=frame_num,
            pps_id=cfg.sps_id * 4,
            slice_qp=qp,
            pic_init_qp=PIC_INIT_QP,
            disable_deblocking_filter_idc=1,
            long_term_idx_update=0,
            max_long_term_frames=cfg.max_long_term_reference_frames)
        headers.write_slice_header_rbsp(bw, shp)
        bw.ue(cfg.n_mb)          # mb_skip_run covering the whole picture
        bw.rbsp_trailing_bits()
        ref_idc, nal_type = headers.slice_nal_header_byte(shp)
        return annexb_nal(ref_idc, nal_type, bw.to_bytes())


def encode_stream(frames, config: EncoderConfig, n_gop: int | None = None,
                  run: RunConfig | None = None, mesh: Mesh | None = None):
    """Encode a frame sequence with GOP-parallel lanes and return the
    in-order Annex-B stream. Lane g takes GOP g, g+n_gop, ...: with fixed
    QP the output is bit-identical to sequential encoding, only the
    schedule differs (the closed-GOP decomposition)."""
    cfg = config
    n_gop = cfg.gop_parallel if n_gop is None else n_gop
    gop = cfg.gop or len(frames)
    n_gops_total = (len(frames) + gop - 1) // gop
    chunks = [frames[i * gop:(i + 1) * gop] for i in range(n_gops_total)]
    payloads = [[] for _ in range(n_gops_total)]
    for base in range(0, n_gops_total, n_gop):
        group = chunks[base:base + n_gop]
        enc = GopBandEncoder(cfg, n_gop=len(group), mesh=mesh,
                             idr_pic_id_base=base % 16,
                             per_lane_idr_pic_id=True)
        for t in range(max(len(c) for c in group)):
            lanes = [c[min(t, len(c) - 1)] for c in group]
            results = enc.encode_step(lanes, run)
            for gi, r in enumerate(results):
                if t < len(group[gi]):
                    payloads[base + gi].append(r.payload)
    return b"".join(b"".join(p) for p in payloads)
