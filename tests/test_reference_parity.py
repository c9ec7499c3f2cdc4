"""Every public name the reference exports must resolve here too.

Name lists are frozen copies of the reference `__all__`s
(gammagl/{models,layers/conv,datasets,utils,transforms,loader}/__init__.py
at v0.6.0) so the test stays hermetic. A reference user switching to this
framework must find every name (possibly as an alias of this framework's
primary class).
"""

import importlib

import pytest

REFERENCE_EXPORTS = {
    "gammagl_tpu.models": [
        "GCNModel", "GATModel", "HEAT", "SGCModel", "GATV2Model",
        "GaANModel", "GraphSAGE_Full_Model", "GraphSAGE_Sample_Model",
        "GCNIIModel", "APPNPModel", "GINModel", "RGCN", "CompGCN",
        "AGNNModel", "JKNet", "HAN", "DGIModel", "GraceModel", "GRADE",
        "ChebNetModel", "SimpleHGNModel", "FAGCNModel", "GPRGNNModel",
        "DGCNNModel", "DGCNN", "HGTModel", "FILMModel", "PNAModel",
        "MixHopModel", "HCHA", "HardGATModel", "MLP", "Generator",
        "Discriminator", "GraphGAN", "VGAEModel", "GAEModel",
        "GEstimationN", "SkipGramModel", "DeepWalkModel", "Node2vecModel",
        "HPN", "GMMModel", "HERec", "MetaPath2Vec", "ieHGCNModel",
        "TADWModel", "MGNNI_m_MLP", "MGNNI_m_att", "NewGrace",
        "CAGCNModel", "CoGSLModel", "GGDModel", "Specformer", "SFGCNModel",
        "Graphormer", "SpaSpeNode", "Encoder", "EigenMLP", "HeCo",
        "FusedGATModel", "Hid_net", "GNNLFHFModel", "DHNModel", "DNAModel",
        "DFADModel", "DFADGenerator", "FatraGNNModel", "Graph_Editer",
        "RoheHAN", "GCILModel", "LogReg", "SGFormerModel", "PreModel",
        "ReModel", "EdgePromptGCNModel", "EdgePromptNodeClassifier",
        "NodeIDGNN", "CoEDModel", "AMPModel", "amp_elbo_regression_loss",
        "GNRF", "GNN", "DeFoGModel", "MERITModel", "InfoGraph",
        "MVGRLModel",
    ],
    "gammagl_tpu.layers.conv": [
        "MessagePassing", "GCNConv", "GATConv", "GATV2Conv", "SAGEConv",
        "SGConv", "GINConv", "APPNPConv", "GCNIIConv", "ChebConv",
        "AGNNConv", "FAGCNConv", "GPRConv", "MixHopConv",
        "JumpingKnowledge", "RGCNConv", "HeteroConv", "HANConv", "HGTConv",
        "SimpleHGNConv", "PNAConv", "FILMConv", "EdgeConv", "GMMConv",
        "CompConv", "GaANConv", "DNAConv", "HypergraphConv", "HPNConv",
        "ieHGCNConv", "RoheHANConv", "HardGATConv", "FusedGATConv",
        "HEATlayer", "Hid_conv", "MAGCLConv", "MGNNI_m_iter", "DHNConv",
        "CoEDConv",
    ],
    "gammagl_tpu.datasets": [
        "Planetoid", "Amazon", "Coauthor", "TUDataset", "Reddit", "PPI",
        "WikiCS", "WebKB", "WikipediaNetwork", "Actor", "IMDB", "DBLP",
        "HGBDataset", "Flickr", "Yelp", "PolBlogs", "BlogCatalog",
        "CA_GrQc", "Entities", "ZINC", "MoleculeNet", "FacebookPagePage",
        "DeezerEurope", "AMiner", "ACM4HeCo", "Bail", "Credit", "NGSIM_US_101",
        "ModelNet40", "AliRCD", "ADDataset",
    ],
    "gammagl_tpu.utils": [
        "calc_gcn_norm", "add_self_loops", "remove_self_loops", "degree",
        "mask_to_index", "index_to_mask", "coalesce", "sort_edge_index",
        "to_undirected", "is_undirected", "k_hop_subgraph",
        "negative_sampling", "to_dense_adj", "to_dense_batch",
        "to_scipy_sparse_matrix", "homophily", "get_laplacian",
        "get_train_val_test_split", "segment_softmax",
        "shortest_path_distance", "batched_shortest_path_distance",
        "calc_A_norm_hat", "edge_index_to_adj_matrix",
        "get_few_shot_split", "node_subgraph", "set_device", "from_smiles",
        "find_all_simple_paths", "read_embeddings",
    ],
    "gammagl_tpu.transforms": [
        "BaseTransform", "Compose", "AddMetaPaths", "DropEdge",
        "NormalizeFeatures", "RandomLinkSplit", "SIGN",
        "SVDFeatureReduction",
    ],
    "gammagl_tpu.loader": [
        "DataLoader", "NeighborSampler", "RandomWalk",
        "GraphSAINTSampler", "GraphSAINTNodeSampler",
        "GraphSAINTRandomWalkSampler", "NodeLoader", "LinkLoader",
    ],
}


@pytest.mark.parametrize("module_name", sorted(REFERENCE_EXPORTS))
def test_reference_names_resolve(module_name):
    mod = importlib.import_module(module_name)
    missing = [n for n in REFERENCE_EXPORTS[module_name]
               if not hasattr(mod, n)]
    assert not missing, f"{module_name} missing reference names: {missing}"
