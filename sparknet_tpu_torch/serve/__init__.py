"""Token serving of the sequence models on a torch device.

Counterpart of ``sparknet_tpu/serve/``, the token-serving part so far:
``paged.PagedDecoder`` (greedy generation over a block-paged K/V cache:
flash-attention prefill, paged-attention decode), its cacheless twin
``continuous.ContinuousDecoder``, and ``paged.TokenRouter`` over decoder
replicas.  The CNN ``ServeEngine`` and its batcher are ROADMAP Queue A7.
"""
