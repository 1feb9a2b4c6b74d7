"""Extensions built on the core framework (reference ``ext/``): pubsub
service, async DB wrappers; the port's copy of ``goworld_tpu/ext``."""
