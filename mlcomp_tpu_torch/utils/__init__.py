"""Jax-free helpers of the port: device selection and the msgpack
export format."""
