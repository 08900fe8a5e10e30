from portbench.harness.guard import forbidden_modules


def test_the_jax_package_trips_and_the_port_does_not():
    assert forbidden_modules(["hypergen_tpu.x", "numpy"]) == ["hypergen_tpu.x"]
    assert forbidden_modules(["hypergen_tpu_torch.x", "hypergen_tpu_torch"]) == []
    assert forbidden_modules(["jax", "jaxlib.xla", "flax.linen", "jaxtyping"]) \
        == ["flax.linen", "jax", "jaxlib.xla"]
