"""Raw records -> tagged text -> token shards (the port's copies of
`omnibiote_tpu/preprocessing/`, which import no JAX)."""
