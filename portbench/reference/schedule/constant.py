"""The learning rate ``lr`` at every update."""


def lr(train_cfg: dict, count: int) -> float:
    return train_cfg["lr"]
