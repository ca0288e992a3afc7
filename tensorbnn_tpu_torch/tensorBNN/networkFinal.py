"""The reference's bundled examples import ``tensorBNN.networkFinal``, a
module the reference itself does not have; provided so those scripts run
with only their import prefix changed."""

from tensorbnn_tpu_torch.tensorBNN.network import Network, network  # noqa: F401
