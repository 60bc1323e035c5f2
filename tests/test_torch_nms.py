"""The port's box math and NMS (``odc_tpu_torch.core``) against the JAX
package, on the CPU, where the suppression wrapper runs its plain version.

NMS order and keep masks must be identical; boxes, conf and class scores
equal within rtol 1e-6 (they are gathers of the same inputs)."""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from odc_tpu.ops.pallas.nms_kernel import pallas_suppress
# The packages' ``core`` re-exports a function named ``nms``: load modules.
jboxes = importlib.import_module("odc_tpu.core.boxes")
jnms = importlib.import_module("odc_tpu.core.nms")
tboxes = importlib.import_module("odc_tpu_torch.core.boxes")
tnms = importlib.import_module("odc_tpu_torch.core.nms")
from odc_tpu_torch.ops.cuda.nms_kernel import suppress, suppress_plain


def _dets(seed, n, num_cls=5, quantize=None, batch=None):
    """Random heavily-overlapping candidates; ``quantize`` rounds the
    confidences to that many levels so equal scores (ties) occur."""
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    boxes = rng.uniform(0, 100, shape + (4,)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 40, shape + (2,)).astype(
        np.float32
    )
    conf = rng.uniform(0, 1, shape).astype(np.float32)
    if quantize:
        conf = (np.round(conf * quantize) / quantize).astype(np.float32)
    cls_scores = rng.uniform(0, 1, shape + (num_cls,)).astype(np.float32)
    return boxes, conf, cls_scores


def test_iou_and_pairwise_match_jax():
    b1, _, _ = _dets(0, 200)
    b2, _, _ = _dets(1, 150)
    got = tboxes.pairwise_iou(torch.tensor(b1), torch.tensor(b2)).numpy()
    ref = np.asarray(jboxes.pairwise_iou(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_array_equal(got, ref)
    got = tboxes.iou(torch.tensor(b1[:150]), torch.tensor(b2)).numpy()
    ref = np.asarray(jboxes.iou(jnp.asarray(b1[:150]), jnp.asarray(b2)))
    np.testing.assert_array_equal(got, ref)
    for fn in ("xyxy_to_cxcywh", "cxcywh_to_xyxy"):
        got = getattr(tboxes, fn)(torch.tensor(b1)).numpy()
        ref = np.asarray(getattr(jboxes, fn)(jnp.asarray(b1)))
        np.testing.assert_array_equal(got, ref, err_msg=fn)


def _jax_nms_padded(boxes, conf, cls_scores, conf_thre, max_keep, sup=None):
    """The JAX function one image at a time (as ``detect.py`` vmaps it)."""
    outs = [
        jnms.nms_padded(
            jnp.asarray(boxes[i]), jnp.asarray(conf[i]),
            jnp.asarray(cls_scores[i]), conf_thre, 0.5, max_keep,
            suppress_boxes=None if sup is None else jnp.asarray(sup[i]),
        )
        for i in range(boxes.shape[0])
    ]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(4)]


def _jax_order(boxes, conf, conf_thre, max_keep):
    return np.stack([
        np.asarray(jnms._suppress(
            jnp.asarray(boxes[i]), jnp.asarray(conf[i]),
            jnp.asarray(conf[i]) >= conf_thre, 0.5, max_keep,
        )[0])
        for i in range(boxes.shape[0])
    ])


@pytest.mark.parametrize(
    "n,max_keep,conf_thre,quantize,class_wise",
    [
        (845, 64, 0.5, None, False),   # top-k branch (the main path's shape)
        (845, 64, 0.3, 8, False),      # quantized scores: ties in the top-k
        (17, 128, 0.3, None, False),   # padding branch (k < max_keep)
        (17, 128, 0.2, 4, False),      # ties in the full sort
        (845, 64, 0.5, None, True),    # class-wise suppression
    ],
)
def test_nms_padded_matches_jax(n, max_keep, conf_thre, quantize, class_wise):
    boxes, conf, cls_scores = _dets(n + max_keep, n, quantize=quantize, batch=3)
    sup = None
    if class_wise:
        sup = np.asarray(jnms.class_offset_boxes(
            jnp.asarray(boxes), jnp.argmax(jnp.asarray(cls_scores), -1)
        ))
        tsup = tnms.class_offset_boxes(
            torch.tensor(boxes), torch.tensor(cls_scores).argmax(-1)
        )
        np.testing.assert_array_equal(tsup.numpy(), sup)
    ref = _jax_nms_padded(boxes, conf, cls_scores, conf_thre, max_keep, sup)
    got = tnms.nms_padded(
        torch.tensor(boxes), torch.tensor(conf), torch.tensor(cls_scores),
        conf_thre, 0.5, max_keep,
        suppress_boxes=None if sup is None else torch.tensor(sup),
    )
    np.testing.assert_array_equal(got[3].numpy(), ref[3], err_msg="keep")
    assert ref[3].any()
    for name, r, g in zip(("boxes", "conf", "cls"), ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, err_msg=name)
    if not class_wise:
        order, _ = tnms._suppress(
            torch.tensor(boxes), torch.tensor(conf),
            torch.tensor(conf) >= conf_thre, 0.5, max_keep,
        )
        np.testing.assert_array_equal(
            order.numpy(), _jax_order(boxes, conf, conf_thre, max_keep)
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_suppress_matches_pallas_interpret(seed):
    """The kernel's plain version against the Pallas kernel (interpret
    mode) at K = 128, on score-sorted candidates of 8 images."""
    boxes, conf, _ = _dets(seed, 128, batch=8)
    order = np.argsort(-conf, axis=-1, kind="stable")
    cand = np.take_along_axis(boxes, order[..., None], axis=1)
    valid = np.take_along_axis(conf, order, axis=1) >= 0.3
    ref = np.asarray(pallas_suppress(
        jnp.asarray(cand), jnp.asarray(valid), 0.5, interpret=True
    ))
    got = suppress(torch.tensor(cand), torch.tensor(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() < valid.sum()  # suppression happened


def test_batched_nms_matches_per_image_loop():
    boxes, conf, cls_scores = _dets(7, 845, batch=4)
    args = [torch.tensor(a) for a in (boxes, conf, cls_scores)]
    batched = tnms.nms_padded(*args, 0.4, 0.5, 64)
    for i in range(4):
        one = tnms.nms_padded(*(a[i : i + 1] for a in args), 0.4, 0.5, 64)
        for b, o in zip(batched, one):
            assert torch.equal(b[i], o[0])


def test_host_nms_matches_jax():
    boxes, conf, cls_scores = _dets(11, 300)
    for class_wise in (False, True):
        ref = jnms.nms(
            jnp.asarray(boxes), jnp.asarray(conf), jnp.asarray(cls_scores),
            0.5, 0.5, 128, class_wise=class_wise,
        )
        got = tnms.nms(
            torch.tensor(boxes), torch.tensor(conf), torch.tensor(cls_scores),
            0.5, 0.5, 128, class_wise=class_wise,
        )
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), r)


def test_suppress_threshold_boundary_is_exact():
    """IoU exactly at the threshold suppresses (``>=``), as in the JAX
    package: two 10x10 boxes offset by 5 px have IoU 50/150 = 1/3."""
    cand = torch.tensor([[[0, 0, 10, 10], [5, 0, 15, 10]]], dtype=torch.float32)
    valid = torch.ones(1, 2, dtype=torch.bool)
    thr = float(tboxes.iou(cand[0, 0], cand[0, 1]))
    assert suppress(cand, valid, thr).tolist() == [[True, False]]
    above = float(np.nextafter(np.float32(thr), np.float32(1)))
    assert suppress_plain(cand, valid, above).tolist() == [[True, True]]


def test_suppress_rejects_bad_inputs():
    with pytest.raises(ValueError):
        suppress(torch.zeros(2, 4), torch.zeros(2, dtype=torch.bool), 0.5)
    with pytest.raises(TypeError):
        suppress(
            torch.zeros(1, 2, 4, dtype=torch.float64),
            torch.zeros(1, 2, dtype=torch.bool), 0.5,
        )


def _ballot(bits):
    """Pack bools [..., 32] into uint32 words, bit l from lane l."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def _emulate_kernel(boxes, valid, iou_thre, seed=0):
    """numpy emulation of ``csrc/nms_suppress.cu``: mask words formed as
    ballots (bit l of word w is candidate 32w + l, lanes past K give 0),
    rows of invalid candidates and words below (i+1)//32 never built (they
    hold random garbage here, so reading one shows), then the walk word by
    word that jumps from kept bit to kept bit."""
    b, k = valid.shape
    nw = (k + 31) // 32
    pad = 32 * nw
    iou = tboxes.pairwise_iou(torch.tensor(boxes), torch.tensor(boxes)).numpy()
    rng = np.random.default_rng(seed)
    keep = np.zeros((b, k), bool)
    j = np.arange(pad)
    for n in range(b):
        vpad = np.zeros(pad, bool)
        vpad[:k] = valid[n]
        valid_words = _ballot(vpad.reshape(nw, 32))
        hits = np.zeros((k, pad), bool)
        hits[:, :k] = iou[n] >= iou_thre
        hits &= j[None, :] > np.arange(k)[:, None]
        built = _ballot(hits.reshape(k, nw, 32))
        mask = rng.integers(0, 2**32, (k, nw), dtype=np.uint64).astype(np.uint32)
        for i in np.flatnonzero(valid[n]):
            first = (i + 1) // 32
            mask[i, first:] = built[i, first:]
        word = [int(x) for x in valid_words]
        for w in range(nw):
            own = [int(mask[32 * w + l, w])
                   if l < 31 and 32 * w + l < k and (int(valid_words[w]) >> l) & 1
                   else 0 for l in range(32)]
            kw = rest = word[w]
            while rest:  # one step per kept box
                bit = (rest & -rest).bit_length() - 1  # __ffs(rest) - 1
                kw &= ~own[bit] & 0xFFFFFFFF
                rest = kw & ~((2 << bit) - 1) & 0xFFFFFFFF
            word[w] = kw
            for lane in range(w + 1, nw):  # the word's kept rows, gathered
                drop = 0
                for bit in range(32):
                    if (kw >> bit) & 1:
                        drop |= int(mask[32 * w + bit, lane])
                word[lane] &= ~drop & 0xFFFFFFFF
        keep[n] = [(word[i >> 5] >> (i & 31)) & 1 for i in range(k)]
    return keep


def _disjoint(b, k):
    step = np.arange(k, dtype=np.float32)[:, None] * 20
    boxes = np.concatenate([step, step, step + 10, step + 10], -1)
    return np.broadcast_to(boxes, (b, k, 4)).copy()


@pytest.mark.parametrize("k", [1, 31, 33, 64, 100, 1024])
@pytest.mark.parametrize("case", ["random", "all_invalid", "all_kept", "tail"])
def test_kernel_walk_emulation_matches_plain(k, case):
    """The kernel's algorithm, emulated in numpy, against the plain version,
    bitwise: valid masks that are not prefixes, K not a multiple of 32, K = 1
    and 1024, nothing valid, and disjoint boxes (every box kept)."""
    b = 2 if k == 1024 else 5
    rng = np.random.default_rng(k)
    boxes, _, _ = _dets(k + 7, k, batch=b)
    valid = rng.uniform(size=(b, k)) < 0.6
    if case == "all_invalid":
        valid[:] = False
    elif case == "all_kept":
        boxes, valid = _disjoint(b, k), np.ones((b, k), bool)
    elif case == "tail":  # valid only past the first word: a non-prefix
        valid[:, : min(k - 1, 32)] = False
    got = _emulate_kernel(boxes, valid, 0.5)
    ref = suppress_plain(torch.tensor(boxes), torch.tensor(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, ref)
    if case == "all_kept":
        assert got.all()
    if case == "random" and k >= 64:
        assert got.sum() < valid.sum()  # suppression happened


def test_kernel_walk_emulation_matches_pallas_interpret():
    """At K = 128, the emulated kernel against the Pallas kernel (interpret
    mode) on score-sorted candidates whose valid mask is not a prefix."""
    boxes, conf, _ = _dets(5, 128, batch=4)
    order = np.argsort(-conf, axis=-1, kind="stable")
    cand = np.take_along_axis(boxes, order[..., None], axis=1)
    valid = np.random.default_rng(5).uniform(size=(4, 128)) < 0.7
    ref = np.asarray(pallas_suppress(
        jnp.asarray(cand), jnp.asarray(valid), 0.5, interpret=True
    ))
    np.testing.assert_array_equal(_emulate_kernel(cand, valid, 0.5), ref)
    assert ref.sum() < valid.sum()


def test_suppress_rejects_misaligned_boxes():
    """The kernel reads each box as one 16-byte load; the wrapper refuses
    boxes that do not start on a 16-byte boundary, on any device."""
    buf = torch.zeros(2 * 4 + 1)
    boxes = buf[1:].view(1, 2, 4)
    assert boxes.is_contiguous() and boxes.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        suppress(boxes, torch.ones(1, 2, dtype=torch.bool), 0.5)
    with pytest.raises(TypeError):
        suppress(torch.zeros(1, 2, 4, dtype=torch.float16),
                 torch.ones(1, 2, dtype=torch.bool), 0.5)
