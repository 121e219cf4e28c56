"""pad_share (batching: the 10 s buckets of dataset_stats_device): the share
of the samples handed to the model step that are padding, 1 - valid samples
/ (rows x bucket samples), over every step of the window. Counted by the
harness's wrapper of the step from the ``audio`` and ``num_valid`` it is
given (a pad row counts one valid sample, the program's convention)."""


def read(ctx):
    c = ctx.record.counters
    if not c.get("bucket_samples"):
        return None
    return 1.0 - c["valid_samples"] / c["bucket_samples"]
