"""Tools of the port (procgen2_tpu/tools): the per-game throughput
bench (`bench_cli`), and the reference-level tools that play the
reference's own fixed-seed levels: the mt19937 oracle (`rng_oracle`),
its layouts as level banks (`reference_levels`), scripted routes
(`scripted`), bots (`bots`) and the independent reward predictors
(`predict`)."""
