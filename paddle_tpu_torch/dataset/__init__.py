"""Built-in dataset loaders (reference python/paddle/dataset/: mnist.py,
cifar.py, uci_housing.py, imdb.py, wmt14/16.py, movielens.py, flowers.py),
the port's own copy of the JAX package's numpy-only readers.

Each module exposes `train()` / `test()` reader creators yielding the same
sample tuples as the reference. Loaders read the standard archive formats
from DATA_HOME (`PADDLE_TPU_DATA_HOME`, default ~/.cache/paddle_tpu/dataset,
the JAX package's directory, so both packages read the same pre-placed
files) when present; nothing is downloaded, so when the files are absent
the loaders yield a deterministic synthetic dataset with identical
shapes/dtypes/ranges (flagged via `is_synthetic()`), keeping every
train/eval pipeline runnable end to end. For the same file, or for none,
both packages yield the same samples bit for bit.
"""
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import movielens  # noqa: F401
from . import flowers  # noqa: F401
from . import conll05  # noqa: F401
from . import sentiment  # noqa: F401
from . import imikolov  # noqa: F401
from . import image  # noqa: F401
from . import mq2007  # noqa: F401
from . import voc2012  # noqa: F401

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "wmt14", "wmt16",
           "movielens", "flowers", "conll05", "sentiment", "imikolov",
           "image", "mq2007", "voc2012"]
