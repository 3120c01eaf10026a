"""JAX-side helpers of the training half's port tests
(``tests/test_torch_train.py``) and goldens
(``tests/golden/make_torch_port_golden.py --only training``)."""

import numpy as np


def jax_dropout_mask(model, params, batch, key):
    """The dropout mask flax draws for ``model.apply(..., train=True,
    rngs={"dropout": key})``, recorded at the ``nn.Dropout`` call:
    ``out != 0`` over the flattened features (where the input is 0 the
    bit changes nothing).  The mask depends on the key and the shape
    only, so it is the one the update step under the same key draws."""
    import flax.linen as nn

    seen = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            seen.append(out)
        return out

    with nn.intercept_methods(record):
        model.apply({"params": params}, batch, train=True,
                    rngs={"dropout": key})
    (out,) = seen
    return np.asarray(out) != 0

