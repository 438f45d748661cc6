"""Median host milliseconds the data feed spends packing one batch of
documents into rows: the program's span ``data.pack`` in
``data/pipeline.py::make_train_batches`` (ended before the batch is
yielded), over the traced steps that record host operations."""
from portbench import program_spans


def read(outcome):
    return program_spans.host("data.pack")
