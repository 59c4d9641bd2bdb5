"""The port's engine: types, backend registry, the plain reference engine,
run generation, the wide merge, the device pipeline and the front door."""
