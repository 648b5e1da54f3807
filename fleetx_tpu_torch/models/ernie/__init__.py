"""ERNIE: the bidirectional encoder, its heads and its weight bridge."""

from fleetx_tpu_torch.models.ernie.model import (  # noqa: F401
    ErnieConfig,
    ErnieForPretraining,
    ErnieForSequenceClassification,
    ErnieModel,
    ernie_pretraining_loss,
)
