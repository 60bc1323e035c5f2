"""Faults planted in the program underneath a bulk cell's timed path, for
the tests that see ``correct`` come out false and for the readings on the
card (``tools/readings.py --faults``).

``plant(name, setattr_)`` patches the program's module attributes through
``setattr_`` (``setattr``, or pytest's ``monkeypatch.setattr``):

- ``half``: half of each batch's answers left out;
- ``swap``: each image gets the next image's answers (an answer altered
  where it is produced);
- ``nosuppress``: the NMS keeps every candidate at the confidence
  threshold, none suppressed.
"""

from __future__ import annotations

FAULTS = ("half", "swap", "nosuppress")


def plant(name: str, setattr_=setattr) -> None:
    if name == "nosuppress":
        import odc_tpu_torch.core.nms as nms_mod

        setattr_(nms_mod, "suppress", lambda boxes, valid, iou_thre: valid.clone())
        return
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; faults: {', '.join(FAULTS)}")
    import odc_tpu_torch.ops.detect as detect_mod

    make = detect_mod.make_infer_fn

    def factory(*a, **kw):
        infer = make(*a, **kw)

        def wrong(images, **k):
            boxes, conf, label, score, keep = infer(images, **k)
            if name == "half":
                keep = keep.clone()
                keep[keep.shape[0] // 2:] = False
            else:
                boxes, conf, label, score, keep = (
                    t.roll(1, 0) for t in (boxes, conf, label, score, keep))
            return boxes, conf, label, score, keep
        return wrong

    setattr_(detect_mod, "make_infer_fn", factory)
