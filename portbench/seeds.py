"""The streams one ``--seed`` gives a run, the same for the program and the
reference: the weights (made by the benchmark), the envs' draws, the
loop's draws (acting, replay; the trainer's own convention, ``seed + 2``)
and the seed of the program's own parameter init (overwritten by the
benchmark's weights)."""


def weights(seed: int) -> int:
    return seed


def agent(seed: int) -> int:
    return seed


def env(seed: int) -> int:
    return seed + 1


def loop(seed: int) -> int:
    return seed + 2
