"""Plain PyTorch references of the port's architectures that the JAX
package does not have, for the tests to hold the port against: plain
``torch`` and f32, importing nothing of the port."""
