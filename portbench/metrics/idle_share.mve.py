"""Per cent of the traced slice in which no device operation ran."""
from portbench.metrics_common import idle_share


def read(outcome):
    return idle_share(outcome)
