"""Device selection and the JAX-weights loader."""
