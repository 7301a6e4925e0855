"""The model objects — counterpart of ``kmlserver_tpu/models/``.

The system's "models" are artifacts, not networks: :class:`RuleModel`
(association-rule tensors on the device + vocabulary + the rule lookup)
and :class:`EmbeddingModel` (ALS item factors on the device + vocabulary +
the cosine top-k), the standalone views for library users who want
recommendations without the job and API stack. Training is
``mining.miner.mine`` / ``mining.als.train_embeddings``, inference
``ops.serve.recommend_batch`` / ``ops.embed.embed_topk``, serialization
``io.artifacts``; these classes compose them.
"""

from .embedding_model import EmbeddingModel  # noqa: F401
from .rule_model import RuleModel  # noqa: F401
