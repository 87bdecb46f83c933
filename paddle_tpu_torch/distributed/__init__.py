"""What the single-card training path needs of the reference's
distributed package (``paddle_tpu/distributed``)."""
