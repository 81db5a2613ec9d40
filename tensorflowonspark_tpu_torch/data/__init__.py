"""The data feed: TFRecord files, tf.Example rows, batches and slabs."""

from tensorflowonspark_tpu_torch.data.indexed import (  # noqa: F401
    CheckpointableInput, IndexedTFRecordDataset, checkpointable_input,
)
