from .step import TrainState, make_train_step, loss_fn  # noqa: F401
