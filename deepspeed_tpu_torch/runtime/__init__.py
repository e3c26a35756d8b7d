"""Training runtime of the port: config, engine, loss scaling, lr schedules."""
