from pccf_torch.data.structures import Inputs, Outputs, Targets, WInputs, WTargets

__all__ = ['Inputs', 'Outputs', 'Targets', 'WInputs', 'WTargets']
