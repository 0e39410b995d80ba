"""K6 ``flash_attention``: online-softmax attention for prefill."""
