"""Faster R-CNN's ops in the PyTorch port against the JAX package:
``ROIPooling`` (forward and data gradient, the plain version of kernels
K8/K8b, and CPU models of K8b's row-band walk and of the per-pixel walk
it replaced, held to each other bit for bit), ``_contrib_Proposal``
(greedy NMS through K7's plain version on the CPU) and ``BlockGrad``.
The graphs of ``models/rcnn.py`` are ``test_torch_rcnn_graphs.py``'s.

Tolerances:

* ROIPooling: the forward exact (a maximum is one of its inputs, and the
  bins are the JAX function's f32 arithmetic; it runs without jit, under
  which XLA rewrites its bin division and could contract ``roi * scale
  + 0.5``); its gradient
  ``rtol=atol=1e-5`` (a pixel's shares of up to four bins and many ROIs
  are summed in another order).
* Proposal: rois and scores bit for bit when the JAX function decodes
  with the same ``exp`` as torch's (a host callback); with XLA's own
  ``exp``, which differs from torch's by an ulp on some f32 inputs,
  the coordinates ``rtol=atol=1e-5`` and the scores exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu.ops import spatial as jspatial
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import roi_pool_kernel as trk

PKGS = (("jax", jmx), ("torch", tmx))


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------
def _rois(rs, R, B, size, lo=0.0):
    """R boxes [b, x1, y1, x2, y2] with corners uniform in [lo, size)."""
    xy = rs.uniform(lo, size, (R, 4))
    out = np.zeros((R, 5), np.float32)
    out[:, 0] = rs.randint(0, B, R)
    out[:, 1] = np.minimum(xy[:, 0], xy[:, 2])
    out[:, 3] = np.maximum(xy[:, 0], xy[:, 2])
    out[:, 2] = np.minimum(xy[:, 1], xy[:, 3])
    out[:, 4] = np.maximum(xy[:, 1], xy[:, 3])
    return out


def _roi_case(name):
    """(data (B, C, H, W), rois (R, 5), pooled_size, spatial_scale)."""
    rs = np.random.RandomState(sum(map(ord, name)))
    B, C, H, W = 2, 4, 9, 13
    data = np.maximum(rs.normal(0, 1, (B, C, H, W)), 0).astype(np.float32)
    scale, pooled = 1 / 16.0, (3, 4)
    rois = _rois(rs, 24, B, 16 * W)
    if name == "ties":
        # whole bins of zeros, and equal positive values inside one bin
        data[0, :, 2:7, 3:10] = 0.0
        data[1, :, 4:6, 4:6] = 2.5
        rois[:6] = [[0, 40, 30, 150, 110]] * 3 + [[1, 60, 60, 100, 100]] * 3
        pooled = (7, 7)
    elif name == "empty-bins":
        # boxes past the right and bottom edges: bins clip to nothing
        rois[:8, 1:] = [16 * W + 10, 16 * H + 10, 16 * W + 90,
                        16 * H + 60]
        rois[8:12, 1:] = [-300, -200, -120, -60]
    elif name == "past-edges":
        rois = _rois(rs, 24, B, 16 * W + 200, lo=-200.0)
    elif name == "half-integer":
        # roi * scale lands on k + 0.5: floor(v + 0.5) rounds up
        rois[:, 1:] = (rs.randint(0, 2 * W, (24, 4)) + 0.5) * 16
        rois[:, 1:] = np.sort(rois[:, 1:].reshape(24, 2, 2), 1).reshape(24, 4)
        rois[:, [1, 2, 3, 4]] = rois[:, [1, 3, 2, 4]]
    elif name == "scale-0.3":
        scale, pooled = 0.3, (2, 5)
        rois = _rois(rs, 24, B, W / 0.3)
    elif name == "batch-index":
        B = 3
        data = rs.normal(0, 1, (B, C, H, W)).astype(np.float32)
        rois[:, 0] = [2, 1, 0, -1, 5, 2.7, -0.5, -1.5] * 3  # clamped, wrapped
    elif name == "empty-band":
        # every ROI within map rows 0-4: the rows below meet none
        ys = np.sort(rs.uniform(0, 60, (24, 2)), 1)
        rois[:, 2], rois[:, 4] = ys[:, 0], ys[:, 1]
    elif name == "interleaved":
        # the two images' ROIs alternate in id order
        rois[:, 0] = np.arange(24) % 2
    return data, rois, pooled, scale


ROI_CASES = ["ties", "empty-bins", "past-edges", "half-integer", "scale-0.3",
             "batch-index", "empty-band", "interleaved"]


def _jax_roi_pooling(data, rois, pooled, scale, g):
    attrs = {"pooled_size": pooled, "spatial_scale": scale}

    def f(d, r):
        return jspatial._roi_pooling(attrs, [d, r], [], True, None)[0]

    with jax.disable_jit():
        out, vjp = jax.vjp(f, jnp.asarray(data), jnp.asarray(rois))
        dx, drois = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), np.asarray(drois)


def _torch_roi_pooling(data, rois, pooled, scale, g):
    """Through the registered op in a bound graph: (out, d data, d rois)."""
    net = tmx.sym.ROIPooling(tmx.sym.Variable("data"),
                             tmx.sym.Variable("rois"), pooled_size=pooled,
                             spatial_scale=scale)
    ex = net.simple_bind(tmx.cpu(), grad_req="write", data=data.shape,
                         rois=rois.shape)
    ex.arg_dict["data"][:] = data
    ex.arg_dict["rois"][:] = rois
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[tmx.nd.array(g)])
    return (out, ex.grad_dict["data"].asnumpy(),
            ex.grad_dict["rois"].asnumpy())


@pytest.mark.parametrize("case", ROI_CASES)
def test_roi_pooling_matches_jax(case):
    """Forward exact, the data gradient ``1e-5``, the ROIs' gradient 0."""
    data, rois, pooled, scale = _roi_case(case)
    rs = np.random.RandomState(5)
    g = rs.normal(0, 1, (len(rois), data.shape[1]) + pooled) \
        .astype(np.float32)
    want = _jax_roi_pooling(data, rois, pooled, scale, g)
    got = _torch_roi_pooling(data, rois, pooled, scale, g)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert not got[2].any() and not want[2].any()
    # the tie counts the backward rebuilds from the channels-last map
    out, bounds, xt = trk.roi_pool_fwd_plain(torch.from_numpy(data),
                                             torch.from_numpy(rois), pooled,
                                             scale)
    m, count = trk.roi_bin_stats(xt, bounds, pooled)
    assert torch.equal(m, out)
    if case == "ties":
        assert (count > 1).sum() > 0 and (want[1] != 0).any()
    if case == "empty-bins":
        assert (count[:12] == 0).all()
        assert (want[0][:12] == 0).all()
    if case == "empty-band":
        assert not want[1][:, :, 5:].any() and not got[1][:, :, 5:].any()
        assert want[1][:, :, :5].any()


def _k8b_model(data, rois, out, count, g, pooled, scale):
    """The thread-a-pixel K8b gather on the CPU: each pixel walks the
    ROIs of its image in ascending order; a ROI's share is its bins
    holding the pixel, in ascending (i, j), each ``g / count`` where the
    pixel equals the bin's maximum (count > 0); the pixel's total adds the
    ROIs' shares in order."""
    B, C, H, W = data.shape
    b, hs, he, ws, we = trk.roi_bounds(rois, B, H, W, pooled, scale)
    hh = torch.arange(H)[:, None]
    ww = torch.arange(W)[None, :]
    acc = torch.zeros_like(data)
    for r in range(rois.shape[0]):
        x = data[b[r]]
        part = torch.zeros_like(x)
        for i in range(pooled[0]):
            rin = (hs[r, i] <= hh) & (hh < he[r, i])
            for j in range(pooled[1]):
                inside = rin & (ws[r, j] <= ww) & (ww < we[r, j])
                n = count[r, :, i, j]
                hit = inside[None] & (x == out[r, :, i, j, None, None]) \
                    & (n > 0)[:, None, None]
                share = g[r, :, i, j] / n.clamp(min=1).to(g.dtype)
                part = torch.where(hit, part + share[:, None, None], part)
        acc[b[r]] = acc[b[r]] + part
    return acc


@pytest.mark.parametrize("case", ROI_CASES)
def test_k8b_gather_model_matches_jax(case):
    """The per-pixel gather (modelled on the CPU on the maxima and
    counts rebuilt from the map) against the JAX gradient, ``1e-5``, and
    against the plain backward."""
    data, rois, pooled, scale = _roi_case(case)
    rs = np.random.RandomState(6)
    g = rs.normal(0, 1, (len(rois), data.shape[1]) + pooled) \
        .astype(np.float32)
    want = _jax_roi_pooling(data, rois, pooled, scale, g)[1]
    td, tr, tg = (torch.from_numpy(a) for a in (data, rois, g))
    out, bounds, xt = trk.roi_pool_fwd_plain(td, tr, pooled, scale)
    m, count = trk.roi_bin_stats(xt, bounds, pooled)
    got = _k8b_model(td, tr, m, count, tg, pooled, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = trk.roi_pool_bwd_plain(xt, bounds, tg, pooled)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)


def _first(seq, pred, start, stop):
    """The first k in [start, stop) with ``pred(seq[k])``, else stop."""
    k = start
    while k < stop and not pred(seq[k]):
        k += 1
    return k


def _bin_range(s, e, a, z, p):
    """The bins of [a, z) holding pixel row (or column) p: [lo, hi]."""
    lo = _first(e, lambda v: v > p, a, z)
    hi = lo - 1
    while hi + 1 < z and s[hi + 1] <= p:
        hi += 1
    return lo, hi


def _k8b_steps(entries, group, cap):
    """K8b's steps over a tile's list ``[(r, i0, i1, j0, j1)]``: up to
    ``group`` whole entries whose bins fit ``cap``, or one chunk of bin
    rows of an entry with more; items ``(entry, i0, i1, first, last)``."""
    pos, row = 0, None
    while pos < len(entries):
        _r, a, z, j0, j1 = entries[pos]
        nj = j1 - j0
        if row is None and (z - a) * nj > cap:
            row = a
        if row is not None:
            zz = min(row + max(1, cap // nj), z)
            yield [(pos, row, zz, row == a, zz == z)]
            pos, row = (pos + 1, None) if zz == z else (pos, zz)
            continue
        items, nb = [], 0
        while pos < len(entries) and len(items) < group:
            _r, a, z, j0, j1 = entries[pos]
            if nb + (z - a) * (j1 - j0) > cap:
                break
            items.append((pos, a, z, True, True))
            nb += (z - a) * (j1 - j0)
            pos += 1
        yield items


def _k8b_tile_model(xt, bounds, g, pooled, plan):
    """The new K8b's walk on the CPU, a channel vector at a time: per tile
    (``plan``'s band of rows by run of columns) the ROIs of its image
    meeting it, compacted in ascending order ``plan["threads"]`` ROIs at
    a time, each with the bin rows and columns meeting the tile; steps of
    them (:func:`_k8b_steps`); each bin's maximum and tie count rebuilt
    from the map; each pixel's share from its bins in ascending (i, j)
    (carried across the steps of a split ROI), added to its sum ROI by
    ROI."""
    B, H, W, C = xt.shape
    ph, pw = pooled
    bb, hs, he, ws, we = [t.tolist() for t in bounds]
    TH, TW = plan["band"], plan["width"]
    dx = torch.zeros((B, C, H, W))
    nan = torch.full((C,), float("nan"))
    for b in range(B):
        for lo in range(0, H, TH):
            hi = min(lo + TH, H)
            for wlo in range(0, W, TW):
                whi = min(wlo + TW, W)
                acc = torch.zeros((hi - lo, whi - wlo, C))
                part = torch.zeros_like(acc)
                for r0 in range(0, len(bb), plan["threads"]):
                    entries = []
                    for r in range(r0, min(r0 + plan["threads"], len(bb))):
                        if (bb[r] == b and hs[r][0] < hi and he[r][-1] > lo
                                and ws[r][0] < whi and we[r][-1] > wlo):
                            i0 = _first(he[r], lambda v: v > lo, 0, ph)
                            j0 = _first(we[r], lambda v: v > wlo, 0, pw)
                            entries.append((
                                r, i0, _first(hs[r], lambda v: v >= hi, i0,
                                              ph),
                                j0, _first(ws[r], lambda v: v >= whi, j0,
                                           pw)))
                    for items in _k8b_steps(entries, plan["group"],
                                            plan["cap"]):
                        for e, i0, i1, first, last in items:
                            r, _a, _z, j0, j1 = entries[e]
                            stats = {}
                            for i in range(i0, i1):
                                for j in range(j0, j1):
                                    win = xt[b, hs[r][i]:he[r][i],
                                             ws[r][j]:we[r][j]]
                                    win = win.reshape(-1, C)
                                    m = win.amax(0) if len(win) else nan
                                    n = (win == m).sum(0)
                                    ok = torch.isfinite(m)
                                    stats[i, j] = (torch.where(ok, m, nan),
                                                   g[r, :, i, j] / n)
                            for h in range(max(hs[r][0], lo),
                                           min(he[r][-1], hi)):
                                ia, ib = _bin_range(hs[r], he[r], i0, i1, h)
                                for w in range(max(ws[r][0], wlo),
                                               min(we[r][-1], whi)):
                                    ja, jb = _bin_range(ws[r], we[r], j0,
                                                        j1, w)
                                    x = xt[b, h, w]
                                    pt = torch.zeros(C) if first \
                                        else part[h - lo, w - wlo]
                                    for i in range(ia, ib + 1):
                                        for j in range(ja, jb + 1):
                                            m, s = stats[i, j]
                                            pt = torch.where(x == m, pt + s,
                                                             pt)
                                    if last:
                                        acc[h - lo, w - wlo] += pt
                                    else:
                                        part[h - lo, w - wlo] = pt
                dx[b, :, lo:hi, wlo:whi] = acc.permute(2, 0, 1)
    return dx


#: K8b tilings the model walks: the plan's own; two-row bands of five
#: columns, steps of at most three ROIs and one bin row a chunk (every
#: ROI with more rows split, its partial sums carried); one-row bands
#: over lists compacted eight ROIs at a time
K8B_PLANS = {"plan": {}, "narrow": dict(band=2, width=5, group=3, cap=1),
             "rows": dict(band=1, threads=8, group=32, cap=64)}


@pytest.mark.parametrize("plan", sorted(K8B_PLANS))
@pytest.mark.parametrize("case", ROI_CASES)
def test_k8b_tile_walk_matches_pixel_walk_and_jax(case, plan):
    """The new K8b's walk (:func:`_k8b_tile_model`) equals the
    per-pixel walk bit for bit and the JAX gradient within ``1e-5``."""
    data, rois, pooled, scale = _roi_case(case)
    rs = np.random.RandomState(7)
    g = rs.normal(0, 1, (len(rois), data.shape[1]) + pooled) \
        .astype(np.float32)
    want = _jax_roi_pooling(data, rois, pooled, scale, g)[1]
    td, tr, tg = (torch.from_numpy(a) for a in (data, rois, g))
    _out, bounds, xt = trk.roi_pool_fwd_plain(td, tr, pooled, scale)
    B, H, W, _C = xt.shape
    p = dict(trk.roi_bwd_plan(H, W), **K8B_PLANS[plan])
    got = _k8b_tile_model(xt, bounds, tg, pooled, p)
    m, count = trk.roi_bin_stats(xt, bounds, pooled)
    old = _k8b_model(td, tr, m, count, tg, pooled, scale)
    assert torch.equal(got.view(torch.int32), old.view(torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if case == "empty-band":
        assert not got[:, :, 5:].any() and got[:, :, :5].any()


def test_k8b_plan_fills_faster_rcnn_map():
    """The default tiling of Faster R-CNN's 37x62 conv5 map: two-row
    bands of the whole width (19 of them), 32 channels and 512 threads a
    block, each thread summing at most eight pixels; wider maps in runs
    of columns."""
    p = trk.roi_bwd_plan(37, 62)
    assert (p["band"], p["width"], p["channels"], p["threads"]) \
        == (2, 62, 32, 512)
    assert p["band"] * p["width"] <= p["threads"] // 32 * 8
    assert trk.roi_bwd_plan(9, 13)["band"] == 9
    wide = trk.roi_bwd_plan(40, 300)
    assert (wide["band"], wide["width"]) == (1, 128)
    # a step holds at least one bin row of the largest pooled size
    assert p["cap"] >= trk.MAX_POOL and p["group"] >= 1


def test_roi_pooling_routes_by_device_and_refuses_what_k8_does_not_take():
    """CPU tensors take the plain versions and count no launch; the
    kernels' wrappers take only CUDA tensors and the shapes they handle."""
    data, rois, pooled, scale = _roi_case("ties")
    before = (trk.roi_pool_fwd_cuda.launches, trk.roi_pool_bwd_cuda.launches)
    td = torch.from_numpy(data).requires_grad_()
    out = trk.roi_pool(td, torch.from_numpy(rois), pooled, scale)
    out.sum().backward()
    assert td.grad is not None
    assert (trk.roi_pool_fwd_cuda.launches,
            trk.roi_pool_bwd_cuda.launches) == before
    tr = torch.from_numpy(rois)
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        trk.roi_pool_fwd_cuda(td.detach(), tr, pooled, scale)
    for bad, match in [((td.detach().double(), tr, pooled), "float32"),
                       ((td.detach(), tr[:, :4], pooled), r"\(R, 5\)"),
                       ((td.detach(), tr, (0, 7)), "pooled"),
                       ((td.detach(), tr, (65, 7)), "pooled"),
                       ((td.detach(), tr[:0], pooled), "empty")]:
        with pytest.raises(tmx.MXNetError, match=match):
            trk.roi_pool_fwd_cuda(*bad, scale)


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------
PROPOSAL_ATTRS = dict(feature_stride=16, scales=(8.0, 16.0, 32.0),
                      ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=150,
                      rpn_post_nms_top_n=60, threshold=0.7,
                      rpn_min_size=16, output_score=True, iou_loss=False)


def _softmax_pairs(rs, B, K, H, W):
    logits = rs.normal(0, 1, (B, 2, K, H, W))
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return p.reshape(B, 2 * K, H, W).astype(np.float32)


def _proposal_case(name):
    """(cls_prob, bbox_pred, im_info, attrs)."""
    rs = np.random.RandomState(sum(map(ord, name)))
    attrs = dict(PROPOSAL_ATTRS)
    B, K, H, W = 2, 9, 4, 6
    info = np.array([[64, 96, 1.0], [56, 90, 0.8]], np.float32)
    cls = _softmax_pairs(rs, B, K, H, W)
    deltas = rs.normal(0, 0.3, (B, 4 * K, H, W)).astype(np.float32)
    if name == "pre-above-anchors":
        attrs["rpn_pre_nms_top_n"] = 5000  # above the 216 anchors
    elif name == "padding":
        # larger boxes over a small image: most are suppressed, and fewer
        # than post_n survive (15 and 14)
        deltas[:, 2::4] = 0.3
        deltas[:, 3::4] = 0.3
        attrs["rpn_pre_nms_top_n"] = 0  # all anchors
    elif name == "min-size":
        attrs["rpn_min_size"] = 60
        deltas[:, 2::4] -= 1.0
    elif name == "equal-scores":
        cls[:] = 0.5  # every anchor ties: the lower index first
        deltas[:, :, :, 3:] = deltas[:, :, :, :1]
    elif name == "iou-0.7":
        # stride 11, one anchor a cell ([0, 0, 10, 10] at the first); the
        # second cell's box moved up by 8 and the third's by 18 (deltas
        # k / 11, rounded to exact shifts), all clipped at the image's
        # bottom edge y = 10: IoUs 70/100 = 0.7 (suppressed, >=) and
        # 60/100 against the first
        attrs.update(feature_stride=11, scales=(1.0,), ratios=(1.0,),
                     rpn_min_size=1, rpn_post_nms_top_n=4)
        B, K, H, W = 1, 1, 3, 1
        info = np.array([[11, 11, 1.0]], np.float32)
        cls = np.zeros((1, 2, 3, 1), np.float32)
        cls[0, 1, :, 0] = [0.9, 0.8, 0.7]
        cls[0, 0] = 1 - cls[0, 1]
        deltas = np.zeros((1, 4, 3, 1), np.float32)
        deltas[0, 1, 1:, 0] = [-8 / 11.0, -18 / 11.0]
    return cls, deltas, info, attrs


PROPOSAL_CASES = ["random", "pre-above-anchors", "padding", "min-size",
                  "equal-scores", "iou-0.7"]


class _TorchExp:
    """``jnp`` with torch's ``exp`` (through a host callback)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jax.pure_callback(
            lambda a: torch.exp(torch.tensor(np.asarray(a))).numpy(),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x,
            vmap_method="legacy_vectorized")


def _jax_proposal(cls, deltas, info, attrs, jit=False):
    """The JAX function's rois and scores; without jit (so that XLA
    cannot contract the decode's multiply-adds) unless ``jit``."""
    def f(c, d, i):
        return jcontrib._proposal_compute(attrs, c, d, i)

    args = [jnp.asarray(a) for a in (cls, deltas, info)]
    if jit:
        rois, scores = jax.jit(f)(*args)
    else:
        with jax.disable_jit():
            rois, scores = f(*args)
    return np.asarray(rois), np.asarray(scores)


def _torch_proposal(cls, deltas, info, attrs):
    outs = tcontrib._proposal(attrs, [torch.from_numpy(a) for a in
                                      (cls, deltas, info)], [], True)
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("exp", ["torch-exp", "xla-exp"])
@pytest.mark.parametrize("case", PROPOSAL_CASES)
def test_proposal_matches_jax(monkeypatch, case, exp):
    """Rois (batch index, box) and scores: bit for bit when both decode
    with torch's ``exp`` (the JAX function without jit); with XLA's (and
    jit), the scores exact and the boxes ``1e-5``."""
    cls, deltas, info, attrs = _proposal_case(case)
    if exp == "torch-exp":
        monkeypatch.setattr(jcontrib, "jnp", _TorchExp())
    want = _jax_proposal(cls, deltas, info, attrs, jit=exp == "xla-exp")
    monkeypatch.undo()
    got = _torch_proposal(cls, deltas, info, attrs)
    post = attrs["rpn_post_nms_top_n"]
    assert got[0].shape == want[0].shape == (len(cls) * post, 5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    if exp == "torch-exp":
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    rows = got[0][:, 1:].reshape(len(cls), post, 4)
    distinct = [len(np.unique(r, axis=0)) for r in rows]
    if case == "padding":
        # the kept boxes, then the first repeated
        assert all(1 < d < post for d in distinct)
        assert (rows[:, -1] == rows[:, 0]).all()
    if case == "iou-0.7":
        np.testing.assert_array_equal(rows[0, :2], [[0, 0, 10, 10],
                                                    [0, 4, 10, 10]])
        assert (rows[0, 2:] == rows[0, 0]).all()


def test_proposal_outputs_only_rois_without_output_score():
    cls, deltas, info, attrs = _proposal_case("random")
    attrs["output_score"] = False
    net = tmx.sym.Proposal(tmx.sym.Variable("c"), tmx.sym.Variable("d"),
                           tmx.sym.Variable("i"), **{
                               k: v for k, v in attrs.items()})
    assert len(net.list_outputs()) == 1
    got = _torch_proposal(cls, deltas, info, attrs)
    assert len(got) == 1
    want = _jax_proposal(cls, deltas, info, dict(attrs, output_score=True),
                         jit=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_proposal_base_anchors_match_jax():
    """Float64 with Python's ``round`` and then cast, as the JAX
    package's ``_gen_base_anchors``, including the defaults' scale 4."""
    for stride, scales, ratios in [(16, (8, 16, 32), (0.5, 1, 2)),
                                   (16, (4.0, 8.0, 16.0, 32.0),
                                    (0.5, 1.0, 2.0)),
                                   (11, (1.0,), (1.0, 0.3, 3.5))]:
        np.testing.assert_array_equal(
            tcontrib.gen_base_anchors(stride, scales, ratios),
            jcontrib._gen_base_anchors(stride, scales, ratios))


# ---------------------------------------------------------------------------
# BlockGrad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["BlockGrad", "stop_gradient"])
def test_block_grad_matches_jax(name):
    """The identity forward, no gradient through it: ``x * BlockGrad(x)``
    differentiates to ``BlockGrad(x)`` alone."""
    rs = np.random.RandomState(2)
    x = rs.normal(0, 1, (3, 5)).astype(np.float32)
    head = rs.normal(0, 1, (3, 5)).astype(np.float32)
    res = []
    for _tag, mx in PKGS:
        v = mx.sym.Variable("x")
        net = v * getattr(mx.sym, name)(v * 3.0)
        ex = net.simple_bind(mx.cpu(), grad_req="write", x=x.shape)
        ex.arg_dict["x"][:] = x
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=[mx.nd.array(head)])
        res.append((out, ex.grad_dict["x"].asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[1][1], 3 * x * head, rtol=1e-6)
