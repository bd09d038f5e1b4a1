"""The paper's DNN workload (Tables 6–7, Fig 3): a softmax MLP trained
with SGD and momentum on class-sorted clustered data, TFIP against LIRS."""
from repro_torch.dnn.mlp import MLPClassifier, make_clustered_data  # noqa: F401
