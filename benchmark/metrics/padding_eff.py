"""padding_eff: the true (unpadded) mel frames of the window's batches over
the frames they were padded to, in percent.  Counted by the harness from
the batches the port's batcher and ``collate`` gave; layer: data batching."""


def read(r):
    w = r.window
    if not w["padded_frames"]:
        return None
    return 100.0 * w["true_frames"] / w["padded_frames"]
