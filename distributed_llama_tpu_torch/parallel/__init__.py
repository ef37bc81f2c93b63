"""Parallelism: tensor parallelism over ranks that share one card
(:mod:`.tensor_parallel`) and the rule table that says how each weight
leaf is cut (:mod:`.sharding`)."""
