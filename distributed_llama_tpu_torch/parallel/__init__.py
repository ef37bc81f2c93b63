"""Parallelism over ranks that share one card: tensor parallelism
(:mod:`.tensor_parallel`), sequence parallelism (:mod:`.context_parallel`)
and expert parallelism (:mod:`.expert_parallel`), one-process pod serving of
replica slices over one shared params tree (:mod:`.pod`), and the rule table
that says how each weight leaf is cut (:mod:`.sharding`)."""
