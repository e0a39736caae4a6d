from pccf_torch.data.structures import Inputs, Outputs, WInputs

__all__ = ['Inputs', 'Outputs', 'WInputs']
