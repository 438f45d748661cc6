"""Mean host milliseconds a window step spends fetching its packed batch
(``data/pipeline.py::make_train_batches``) and copying it to the device:
the benchmark's own span around that call."""


def read(outcome):
    return outcome.spans.mean_ms("fetch") if outcome.spans else None
