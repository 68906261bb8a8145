"""``loss_span_ms`` under a name of its own for the cells that entry's
list does not hold: device milliseconds an epoch of work inside the
program's ``loss`` spans (here the VAE loss's forward and backward, its
``gram`` spans included)."""
from metrics.loss_span_ms import read  # noqa: F401
