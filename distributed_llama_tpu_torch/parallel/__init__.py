"""Parallelism: tensor parallelism over ranks that share one card
(:mod:`.tensor_parallel`), one-process pod serving of replica slices over
one shared params tree (:mod:`.pod`), and the rule table that says how each
weight leaf is cut (:mod:`.sharding`)."""
