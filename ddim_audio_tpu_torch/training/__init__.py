"""Training: loss, parameter groups, optimizers, EMA and the train step
(port of ``ddim_audio_tpu/training``)."""
