"""Share of the traced window in which no operation ran on the device: one
minus the union of the profiler's device intervals (not their sum) over
the window's length."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
