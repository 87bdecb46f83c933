"""The ``pretrained=True`` gate of the model zoo (counterpart of
``paddle_tpu/vision/models/_pretrained.py``): trained weights would be
downloaded, and the port has no network, so asking for them raises
instead of returning random weights."""

__all__ = ["UnavailableError", "require_no_pretrained"]


class UnavailableError(RuntimeError):
    """A resource the call needs cannot be had here (the reference's
    ``framework.errors.UnavailableError``)."""


def require_no_pretrained(name, pretrained):
    if pretrained:
        raise UnavailableError(
            f"{name}(pretrained=True): this environment has no network "
            "egress, so reference pretrained weights cannot be downloaded. "
            f"Build the model with pretrained=False and load local weights "
            f"via model.set_state_dict(...) or load_jax_weights instead.")
