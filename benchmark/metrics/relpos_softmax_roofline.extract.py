"""relpos_softmax_roofline.extract: the attention score kernel's share of
its roofline.

The least time the card could take for the window's score rows (their
bytes at the HBM peak: per block, head and valid subsampled query row of
every chunk, one row of ``ac`` and one band of ``bd`` read and one row of
probabilities written, 12 T' bytes; the model kind's ``relpos_bytes``)
over the device time of every launch of the `relpos_softmax` kernel in
the trace.  The chunks are counted from the mix: every shard holds the
pool's durations (`harness.audio.durations`), each utterance's frames
(`reference.frontend.num_frames`, every frame voiced: the configuration
has no VAD) cut by the extraction's rule (`reference.extract.chunks`),
times the window's shards.  Padded rows and frames are not counted."""

from harness.audio import durations
from reference.extract import chunks
from reference.frontend import num_frames


def read(out, cell, peaks):
    if out.trace is None or peaks is None:
        return None
    t = out.trace.kernel_seconds("relpos_softmax")
    if t <= 0:
        return None
    cfg, tr = cell.config, cell.traffic
    sr = tr["audio"]["sample_rate"]
    shard = sum(cell.model.relpos_bytes(cfg, length)
                for s in durations(tr["duration_s"], tr["pool_utts"])
                for _, length in chunks(num_frames(int(round(s * sr)), cfg["frontend"]),
                                        cfg["extract"]))
    return 100.0 * shard * out.work["shards"] / peaks["hbm_bytes_per_s"] / t
