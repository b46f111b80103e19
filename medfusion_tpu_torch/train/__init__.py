"""Training (port of ``medfusion_tpu/train``): the train state with AdamW
and EMA and the two-player state, learning-rate schedules, and the
diffusion and flow-matching train steps; the autoencoder's step is in
``train/autoencoder.py``, its adversarial step in ``train/adversarial.py``,
the noisy-latent classifier's in ``train/classifier.py``, what the training
CLIs share around their steps in ``train/loop.py``."""

from medfusion_tpu_torch.train.classifier import ClassifierTrainer, make_classifier_train_step
from medfusion_tpu_torch.train.diffusion import make_diffusion_train_step
from medfusion_tpu_torch.train.ema import ema_decay, ema_update
from medfusion_tpu_torch.train.flow import make_flow_train_step
from medfusion_tpu_torch.train.lr_schedules import make_lr_schedule
from medfusion_tpu_torch.train.state import GANTrainState, TrainState

__all__ = ["ClassifierTrainer", "GANTrainState", "TrainState", "ema_decay", "ema_update",
           "make_classifier_train_step", "make_diffusion_train_step", "make_flow_train_step",
           "make_lr_schedule"]
