"""The part of set-up that builds the program's kernel libraries and its
native scheduler, or finds them built in the checkout's build directory
(``sanafe_tpu_torch/build/``): seconds on the host's clock. Only a
checkout's first run builds; the others find them."""


def read(run: dict):
    return run["build_s"]
