from .step import (TrainConfig, chunked_softmax_xent, compile_train_step, loss_fn,
                   make_train_state, make_train_step)

__all__ = ["TrainConfig", "chunked_softmax_xent", "compile_train_step", "loss_fn",
           "make_train_state", "make_train_step"]
