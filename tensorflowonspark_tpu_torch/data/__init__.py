"""The data feed: TFRecord files, tf.Example rows, batches and slabs."""
