"""Peak device memory of the window, GiB: torch.cuda.max_memory_allocated()
after reset_peak_memory_stats() at the window's start."""
LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return tr.values["memory_peak_bytes"] / 2**30
