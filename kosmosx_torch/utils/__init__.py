"""The weight bridge from JAX parameter trees."""
